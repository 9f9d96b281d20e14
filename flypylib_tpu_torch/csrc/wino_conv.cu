// Winograd F(2x2x2, 3x3x3) valid conv + bias + optional ReLU over NDHWC
// volumes (sm_90a).
//
// Replaces the TPU kernel flypylib_tpu/ops/wino_conv.py::wino_conv3d_bias_relu.
// For x (N,D,H,W,Ci) with D, H, W even, u (64,Cip,Cop) the transform-domain
// weights U = (G (x) G (x) G) w rounded to x's dtype T and zero-padded to
// multiples of 16, and b (Co,) in T, it computes the valid 3^3 conv of
// shape (N, D-2, H-2, W-2, Co), with the reference kernel's rounding points:
//
//   - the input transform B^T x B runs per axis, z then y then x; each of
//     its stages is one signed sum of two T values, rounded to T;
//   - each of the 64 taps t is a product V_t @ U_t of T values summed in
//     f32 (m_t), and each output phase g = (gz*2+gy)*2+gx accumulates
//     acc[g] += A_t[g] * m_t in f32, in tap order, A_t[g] in {-1, 0, 1}
//     being the inverse transform's coefficient;
//   - then acc[g] + f32(b), ReLU, and one rounding to T.
//
// This file holds the first versions: f32 (wino_fma_kernel) and the bf16
// calls the wgmma kernel of wino_conv_wgmma.cu does not take (Ci or Co off
// the multiples of 8, or x off a 16-byte boundary: wino_wmma_kernel); the
// Python wrapper picks (ops/wino_conv.py::wino_route).
//
// What bounds them on an H100: at the packed baseline's stage-B shapes
// ((64,36^3,32) -> (64,34^3,48) and (64,34^3,48) -> (64,32^3,64), bf16)
// the Winograd products are 6.2e10 and 1.03e11 FLOP against 191 + 226 MB
// and 226 + 268 MB in and out, about 160-210 FLOP per byte: under the
// card's bf16 ridge of ~295, so the floor is the bytes.  Each input value
// is read by up to 8 blocks (the 4^3 tiles of neighbouring 2^3 output
// blocks overlap by 2 on each axis), so the halo loads, which L2 serves in
// part, and the transforms in shared memory are what these kernels spend
// their time on.
//
// Design, simple first: a block owns one z-block and one y-block of 2^3
// output blocks and a run of up to MX of them along x (MX <= 32), and up
// to 128 output channels (a wider layer runs as one launch per block of
// output channels).  Per pass of its K loop (128 input channels):
//   1. It loads the pass's channels of the 4 x 4 x (2 MX + 2) halo into
//      shared memory.
//   2. It runs the z and the y stages of B^T in place (each column of four
//      values becomes its four transform rows), leaving T2[A][B] per x
//      position.
//   3. For each (A, B), it runs the x stage into a (4, MP, Ccp) tile V
//      (MP: MX rounded up to 16; padding rows and channels are zeros), then
//      for each of the four taps (A, B, C) takes the (MP, Ccp) @ (Ccp, Cop)
//      product with f32 accumulation -- bf16 on WMMA tensor cores (U read
//      straight from device memory, where it stays in L2), f32 on CUDA-core
//      FMAs -- and folds it with the inverse transform's signs into eight
//      f32 phase accumulators held in registers (WMMA accumulator
//      fragments for bf16).
//   4. After the last pass the epilogue adds the bias, applies ReLU, rounds
//      once and writes the eight phases interleaved into the NDHWC output
//      (the reference writes phase-major and transposes afterwards, a
//      Mosaic workaround).
//
// C entry: fpl_wino_conv(...) launches on the given stream and returns
// cudaGetLastError(); it allocates nothing and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// a +- b rounded to T once (exact in f32 before the rounding to bf16:
// f32 keeps more than twice bf16's precision, so the double rounding is
// the single one)
template <typename T>
__device__ __forceinline__ T add(T a, T b) {
  return from_f32<T>(to_f32(a) + to_f32(b));
}
template <typename T>
__device__ __forceinline__ T sub(T a, T b) {
  return from_f32<T>(to_f32(a) - to_f32(b));
}

// Row r of B^T = [[1,0,-1,0], [0,1,1,0], [0,-1,1,0], [0,1,0,-1]] applied to
// four positions, spelled as the reference's _bt_combine spells it:
// v0 - v2, v1 + v2, v2 - v1, v1 - v3
template <typename T>
__device__ __forceinline__ T bt_row(int r, T v0, T v1, T v2, T v3) {
  switch (r) {
    case 0: return sub(v0, v2);
    case 1: return add(v1, v2);
    case 2: return sub(v2, v1);
    default: return sub(v1, v3);
  }
}

// A^T = [[1,1,1,0], [0,1,-1,-1]]: coefficient of transform row r in output
// phase p
__host__ __device__ constexpr int at(int p, int r) {
  return p == 0 ? (r < 3 ? 1 : 0) : (r == 0 ? 0 : (r == 1 ? 1 : -1));
}

// coefficient of tap (A, B, C) in phase g
__host__ __device__ constexpr int phase_coef(int g, int A, int B, int C) {
  return at(g >> 2, A) * at((g >> 1) & 1, B) * at(g & 1, C);
}

constexpr int kThreads = 256;

struct Geometry {
  int D, H, W, Ci, Co, Cop;
  int ldo;         // channels of an output voxel (>= Co: a block of a wider layer)
  int Cc, Ccp;     // input channels per pass of the K loop, and padded to 16
  int ldu;         // rows of one tap of u: Ci padded to 16
  int MD, MH, MW;  // output blocks per axis
  int MX, nq;      // x-blocks per block (at most), x-chunks per row
  int ts_bytes;    // bytes of the halo tile; V follows it
  int relu, vec;   // vec: 16-byte halo loads
};

// Steps 1-2: channels c0 .. c0 + cc of the halo of block (n, i, j, x0) into
// Ts, and B^T's z and y stages in place.  Ts[(A*4+B)*run + xpos*cc + c]
// then holds T2[A][B] at x position xpos, channel c0 + c (run = (2 mx + 2) cc).
template <typename T>
__device__ __forceinline__ void halo_zy(const T* __restrict__ x, T* Ts,
                                        const Geometry& g, long long n, int i,
                                        int j, int x0, int c0, int cc,
                                        int run) {
  const int tid = threadIdx.x;
  const long long row0 = ((n * g.D + 2 * i) * g.H + 2 * j) * (long long)g.W;
  if (g.vec) {  // cc values of a voxel are whole 16-byte units on both sides
    const int per = cc * (int)sizeof(T) / 16, run16 = run * (int)sizeof(T) / 16;
    for (int e = tid; e < 16 * run16; e += kThreads) {
      const int zy = e / run16, r = e - zy * run16;
      const int xpos = r / per, cu = r - xpos * per;
      const long long src =
          (row0 + ((long long)(zy >> 2) * g.H + (zy & 3)) * g.W + 2 * x0 +
           xpos) * g.Ci + c0;
      reinterpret_cast<uint4*>(Ts)[e] =
          reinterpret_cast<const uint4*>(x + src)[cu];
    }
  } else {
    for (int e = tid; e < 16 * run; e += kThreads) {
      const int zy = e / run, r = e - zy * run;
      const int xpos = r / cc, c = r - xpos * cc;
      const long long src =
          (row0 + ((long long)(zy >> 2) * g.H + (zy & 3)) * g.W + 2 * x0 +
           xpos) * g.Ci + c0;
      Ts[e] = x[src + c];
    }
  }
  __syncthreads();
  // z stage: each (y, xpos, c) column of four z values -> its four rows
  const int plane = 4 * run;
  for (int e = tid; e < plane; e += kThreads) {
    T* col = Ts + e;
    const T v0 = col[0], v1 = col[plane], v2 = col[2 * plane],
            v3 = col[3 * plane];
#pragma unroll
    for (int r = 0; r < 4; ++r) col[r * plane] = bt_row(r, v0, v1, v2, v3);
  }
  __syncthreads();
  // y stage: for each z row A, each (xpos, c) column of four y values
  for (int e = tid; e < plane; e += kThreads) {
    const int A = e / run, rr = e - A * run;
    T* col = Ts + A * plane + rr;
    const T v0 = col[0], v1 = col[run], v2 = col[2 * run], v3 = col[3 * run];
#pragma unroll
    for (int r = 0; r < 4; ++r) col[r * run] = bt_row(r, v0, v1, v2, v3);
  }
  __syncthreads();
}

// Step 3's x stage for one (A, B): V[C][k][c] = row C of B^T over x
// positions 2k .. 2k+3 of T2[A][B]; rows k >= mx and channels c >= Ci are 0
template <typename T, int MP>
__device__ __forceinline__ void stage_x(const T* t2, T* Vs, int mx, int Ci,
                                        int Cip, int VLd) {
  for (int e = threadIdx.x; e < 4 * MP * Cip; e += kThreads) {
    const int C = e / (MP * Cip);
    const int r = e - C * MP * Cip;
    const int k = r / Cip, c = r - k * Cip;
    T v = from_f32<T>(0.f);
    if (k < mx && c < Ci) {
      const T* p = t2 + 2 * k * Ci + c;
      v = bt_row(C, p[0], p[Ci], p[2 * Ci], p[3 * Ci]);
    }
    Vs[(C * MP + k) * VLd + c] = v;
  }
}

// block index -> (n, i, j, x0, mx)
__device__ __forceinline__ void block_coords(const Geometry& g, long long& n,
                                             int& i, int& j, int& x0,
                                             int& mx) {
  long long bid = blockIdx.x;
  const int q = (int)(bid % g.nq);
  bid /= g.nq;
  j = (int)(bid % g.MH);
  bid /= g.MH;
  i = (int)(bid % g.MD);
  n = bid / g.MD;
  x0 = q * g.MX;
  mx = min(g.MX, g.MW - x0);
}

__device__ __forceinline__ long long out_offset(const Geometry& g, long long n,
                                                int z, int y, int xo) {
  return (((n * (g.D - 2) + z) * (g.H - 2) + y) * (long long)(g.W - 2) + xo) *
         g.ldo;
}

// ------------------------------------------------ bf16 on WMMA tensor cores
template <int MP>
__global__ void __launch_bounds__(kThreads, 2)  // 128 registers: two blocks an SM
wino_wmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ u,
                 const bf16* __restrict__ b, bf16* __restrict__ out,
                 Geometry g) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  long long n;
  int i, j, x0, mx;
  block_coords(g, n, i, j, x0, mx);
  const int VLd = g.Ccp + 8;    // V row pitch (bf16); fragment rows stay
  const int CLd = g.Cop + 4;    // 32-byte aligned; C row pitch (f32)
  bf16* Ts = reinterpret_cast<bf16*>(smem);
  bf16* Vs = reinterpret_cast<bf16*>(smem + g.ts_bytes);
  float* Cs = reinterpret_cast<float*>(Vs + 4 * MP * VLd);

  // each warp owns at most one 16 x 16 output tile (MP/16 x Cop/16 <= 8)
  const int warp = threadIdx.x / 32;
  const int nct = g.Cop / 16;
  const bool has_tile = warp < (MP / 16) * nct;
  const int rt = warp / nct, ct = warp - (warp / nct) * nct;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[8];
#pragma unroll
  for (int p = 0; p < 8; ++p) wmma::fill_fragment(acc[p], 0.f);

  // the K loop: Cc input channels a pass, each pass's products folded into
  // the phase accumulators
  for (int c0 = 0; c0 < g.Ci; c0 += g.Cc) {
  const int cc = min(g.Cc, g.Ci - c0), ccp = (cc + 15) / 16 * 16;
  const int run = (2 * mx + 2) * cc;
  halo_zy(x, Ts, g, n, i, j, x0, c0, cc, run);
#pragma unroll
  for (int A = 0; A < 4; ++A) {
#pragma unroll
    for (int B = 0; B < 4; ++B) {
      stage_x<bf16, MP>(Ts + (A * 4 + B) * run, Vs, mx, cc, ccp, VLd);
      __syncthreads();
      if (has_tile) {
#pragma unroll
        for (int C = 0; C < 4; ++C) {
          const int t = (A * 4 + B) * 4 + C;
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> m;
          wmma::fill_fragment(m, 0.f);
          const bf16* ut =
              u + ((long long)t * g.ldu + c0) * g.Cop + ct * 16;
          const bf16* vt = Vs + (C * MP + rt * 16) * VLd;
          for (int k0 = 0; k0 < ccp; k0 += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
            wmma::load_matrix_sync(af, vt + k0, VLd);
            wmma::load_matrix_sync(bfr, ut + (long long)k0 * g.Cop, g.Cop);
            wmma::mma_sync(m, af, bfr, m);
          }
#pragma unroll
          for (int p = 0; p < 8; ++p) {
            const int coef = phase_coef(p, A, B, C);
            if (coef > 0) {
#pragma unroll
              for (int e = 0; e < m.num_elements; ++e) acc[p].x[e] += m.x[e];
            } else if (coef < 0) {
#pragma unroll
              for (int e = 0; e < m.num_elements; ++e) acc[p].x[e] -= m.x[e];
            }
          }
        }
      }
      __syncthreads();  // V consumed before the next (A, B) overwrites it
    }
  }
  }

  // epilogue, one phase at a time through the f32 tile Cs
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    if (has_tile)
      wmma::store_matrix_sync(Cs + rt * 16 * CLd + ct * 16, acc[p], CLd,
                              wmma::mem_row_major);
    __syncthreads();
    const int gz = p >> 2, gy = (p >> 1) & 1, gx = p & 1;
    for (int e = threadIdx.x; e < mx * g.Co; e += kThreads) {
      const int k = e / g.Co, o = e - k * g.Co;
      float v = Cs[k * CLd + o] + __bfloat162float(b[o]);
      if (g.relu) v = fmaxf(v, 0.f);
      out[out_offset(g, n, 2 * i + gz, 2 * j + gy, 2 * (x0 + k) + gx) +
          o] = __float2bfloat16_rn(v);
    }
    __syncthreads();
  }
}

// ------------------------------------------------------ f32 on CUDA cores
// MP = 16 rows; thread (r, l) owns row r and columns l + 16 q, q < QN
template <int QN>
__global__ void __launch_bounds__(kThreads)
wino_fma_kernel(const float* __restrict__ x, const float* __restrict__ u,
                const float* __restrict__ b, float* __restrict__ out,
                Geometry g) {
  constexpr int MP = 16;
  extern __shared__ __align__(128) unsigned char smem[];
  long long n;
  int i, j, x0, mx;
  block_coords(g, n, i, j, x0, mx);
  const int VLd = g.Ccp + 8;
  float* Ts = reinterpret_cast<float*>(smem);
  float* Vs = reinterpret_cast<float*>(smem + g.ts_bytes);

  const int r = threadIdx.x / 16, l = threadIdx.x % 16;
  float acc[8][QN];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < QN; ++q) acc[p][q] = 0.f;

  for (int c0 = 0; c0 < g.Ci; c0 += g.Cc) {  // the K loop, as above
  const int cc = min(g.Cc, g.Ci - c0), ccp = (cc + 15) / 16 * 16;
  const int run = (2 * mx + 2) * cc;
  halo_zy(x, Ts, g, n, i, j, x0, c0, cc, run);
#pragma unroll
  for (int A = 0; A < 4; ++A) {
#pragma unroll
    for (int B = 0; B < 4; ++B) {
      stage_x<float, MP>(Ts + (A * 4 + B) * run, Vs, mx, cc, ccp, VLd);
      __syncthreads();
#pragma unroll
      for (int C = 0; C < 4; ++C) {
        const int t = (A * 4 + B) * 4 + C;
        const float* ut = u + ((long long)t * g.ldu + c0) * g.Cop + l;
        const float* vr = Vs + (C * MP + r) * VLd;
        float m[QN];
#pragma unroll
        for (int q = 0; q < QN; ++q) m[q] = 0.f;
        for (int c = 0; c < cc; ++c) {
          const float a = vr[c];
#pragma unroll
          for (int q = 0; q < QN; ++q)
            if (l + 16 * q < g.Cop)
              m[q] = fmaf(a, __ldg(ut + (long long)c * g.Cop + 16 * q), m[q]);
        }
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          const int coef = phase_coef(p, A, B, C);
          if (coef > 0) {
#pragma unroll
            for (int q = 0; q < QN; ++q) acc[p][q] += m[q];
          } else if (coef < 0) {
#pragma unroll
            for (int q = 0; q < QN; ++q) acc[p][q] -= m[q];
          }
        }
      }
      __syncthreads();  // V consumed before the next (A, B) overwrites it
    }
  }
  }

  if (r >= mx) return;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int gz = p >> 2, gy = (p >> 1) & 1, gx = p & 1;
    const long long base =
        out_offset(g, n, 2 * i + gz, 2 * j + gy, 2 * (x0 + r) + gx);
#pragma unroll
    for (int q = 0; q < QN; ++q) {
      const int o = l + 16 * q;
      if (o < g.Co) {
        float v = acc[p][q] + b[o];
        if (g.relu) v = fmaxf(v, 0.f);
        out[base + o] = v;
      }
    }
  }
}

constexpr int kSmemBudget = 200 * 1024;

int round_up(int v, int m) { return (v + m - 1) / m * m; }

// shared memory of a block: the halo, V and (bf16) the f32 epilogue tile
int smem_bytes(const Geometry& g, int MP, int elem, bool wmma_path) {
  return g.ts_bytes + 4 * MP * (g.Ccp + 8) * elem +
         (wmma_path ? MP * (g.Cop + 4) * 4 : 0);
}

}  // namespace

// x (N,D,H,W,Ci), u (64,Cip,Cop), b (Co,) and out (N,D-2,H-2,W-2,ldo), of
// which the call writes Co <= 128 channels starting at `out` (a wider layer
// runs as one call per block of output channels, each with its own u, b and
// channel offset into out); all contiguous, in one dtype: 0 = float32, 1 =
// bfloat16.  Cip and Cop are Ci and Co rounded up to multiples of 16 (u's
// padding is zeros).  Any Ci: the kernels' K loop takes 128 input channels
// a pass.  Shapes are checked by the Python wrapper
// (flypylib_tpu_torch/ops/wino_conv.py).
extern "C" int fpl_wino_conv(const void* x, const void* u, const void* b,
                             void* out, int N, int D, int H, int W, int Ci,
                             int Co, int ldo, int relu, int dtype,
                             void* stream) {
  cudaGetLastError();  // clear any earlier, unrelated error
  if (N < 1 || Ci < 1 || Co < 1 || Co > 128 || ldo < Co || D < 4 || H < 4 ||
      W < 4 || D % 2 || H % 2 || W % 2 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const bool wmma_path = dtype == 1;
  const int elem = wmma_path ? 2 : 4;
  Geometry g;
  g.D = D; g.H = H; g.W = W; g.Ci = Ci; g.Co = Co; g.ldo = ldo;
  g.Cc = Ci < 128 ? Ci : 128;
  g.Ccp = round_up(g.Cc, 16);
  g.ldu = round_up(Ci, 16);
  g.Cop = round_up(Co, 16);
  g.MD = (D - 2) / 2; g.MH = (H - 2) / 2; g.MW = (W - 2) / 2;
  g.relu = relu ? 1 : 0;
  // x-blocks per block: at most 32 rows (16 when a WMMA tile row would
  // hold more than 8 tiles, and always for the FMA path), halved until
  // shared memory fits, then spread evenly over the chunks of a row
  int MX = (wmma_path && g.Cop <= 64) ? 32 : 16;
  if (MX > g.MW) MX = g.MW;
  for (;;) {
    const int MP = MX > 16 ? 32 : 16;
    g.ts_bytes = round_up(16 * (2 * MX + 2) * g.Cc * elem, 128);
    if (smem_bytes(g, MP, elem, wmma_path) <= kSmemBudget || MX <= 1) break;
    MX = (MX + 1) / 2;
  }
  g.nq = (g.MW + MX - 1) / MX;
  g.MX = (g.MW + g.nq - 1) / g.nq;
  const int MP = g.MX > 16 ? 32 : 16;
  g.ts_bytes = round_up(16 * (2 * g.MX + 2) * g.Cc * elem, 128);
  const int smem = smem_bytes(g, MP, elem, wmma_path);
  g.vec = ((long long)Ci * elem % 16 == 0 &&
           reinterpret_cast<uintptr_t>(x) % 16 == 0)
              ? 1 : 0;
  const long long blocks = (long long)N * g.MD * g.MH * g.nq;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (wmma_path) {
    auto kernel = MP == 32 ? wino_wmma_kernel<32> : wino_wmma_kernel<16>;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)blocks, kThreads, smem, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(u),
        static_cast<const bf16*>(b), static_cast<bf16*>(out), g);
  } else {
    const int qn = g.Cop / 16;
    auto kernel = qn <= 2   ? wino_fma_kernel<2>
                  : qn <= 4 ? wino_fma_kernel<4>
                            : wino_fma_kernel<8>;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)blocks, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(u),
        static_cast<const float*>(b), static_cast<float*>(out), g);
  }
  return (int)cudaGetLastError();
}
