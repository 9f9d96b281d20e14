// K1's f32 route for Ci > 1, and the f32 stages of the decoder tail (K2,
// K3), on Hopper: a valid conv + bias + ReLU on CUDA-core FMAs, the input
// halo staged once per channel slice by TMA (sm_90a).
//
// Replaces, in f32:
// - the TPU kernel flypylib_tpu/ops/pallas_conv.py:155 (conv3d_bias_relu)
//   for x (B,D,H,W,Ci) with Ci % 4 == 0, a 16-byte-aligned x and a
//   dilation whose halo fits shared memory (ops/conv.py::k1_route, route
//   "simt"): the dilated 3x3x3 conv, C entry fpl_conv3d_f32;
// - every stage of flypylib_tpu/ops/pallas_tail.py:221 (packed_tail, K2)
//   and :470 (packed_tail2, K3) with Ca and Cb multiples of 4 and 16-byte-
//   aligned operands (ops/tail.py::tail_route, route "simt"): the valid 2^3
//   conv at d = 1 of xa, plus that of xb for K3's first stage, C entry
//   fpl_tail_stage_f32.  In f32 the TPU kernel's "round to the dtype, add
//   the dtype bias, round" is the f32 sum plus the f32 bias, so a stage is
//   this kernel's function.
// csrc/conv3d_bias_relu.cu and csrc/packed_tail.cu keep every other f32
// call ("fma").  It computes, as those kernels and their plain versions
// do, with T taps a side (3 for K1, 2 for a tail stage),
//
//   out[n,z,y,x,o] = relu(sum_{tz,ty,tx,c} x[n, z+tz*d, y+ty*d, x+tx*d, c]
//                                           * w[tz,ty,tx,c,o] + b[o])
//
// (for K3's first stage the same sum over xb and wb added into it) in f32:
// the products on FMAs (no TF32, not even 3xTF32: the f32 model is the
// port's exactness mode), summed in f32, the f32 bias, then ReLU unless
// relu = 0.
//
// What bounds it on an H100: operations.  Every input value feeds T^3*Co
// products: the baseline's layers 1-3 are 0.68 TFLOP a tile batch at
// 256^3, 10.15 ms of the card's 67 TFLOP/s f32 FMA rate, while their bytes
// are 0.3 ms of device memory; the tail's two stages at 256^3 (one
// covering tile of 132^3 cells, K = 8 * 240 and 8 * 192 into Co = 192) are
// 2.95 TFLOP, 44.1 ms, against ~2 ms of bytes.  So the design keeps the
// loads off the FMA path:
// - A block owns one output box of at most 256 voxels (bz*by*bx, bx a
//   multiple of 8 where the output is that wide; ops/conv.py::simt_plan
//   picks the box that covers the output in the fewest blocks, then the one
//   with the least halo) of one batch entry, and one block of at most 64
//   output channels for K1, 32 for a tail stage (gridDim.y blocks of equal
//   width, as ops/conv.py::wgmma_chunks splits a wider Co).  At the tail's
//   Co = 192, three 4-warp blocks an SM ran the main path's stages 7%
//   faster than one 8-warp block of 64 (PERF.md).
// - K runs over slices of 4 input channels: xa's, then xb's.  For each, one
//   TMA 5-D load of the box (4, bx+r, by+r, bz+r, 1), r = (T-1)*d, from
//   the slice's operand brings the box's whole input halo, zero-filled past
//   the volume, and one bulk copy brings the slice's weights for all T^3
//   taps from an image the wrapper lays out (ops/conv.py::simt_weights:
//   [channel block][slice][tap][group][c][8], zero past Co; for K3 xa's
//   slices then xb's, ops/tail.py::tail_simt_weights).  All taps then read
//   the one staged halo: each input value comes through L2 once per slice,
//   not once per tap, and the concat of K3's operands never exists.  A ring
//   of stages lands the next slices under this one's FMAs (two for K1;
//   four for a tail stage, whose 8 taps do 2048 FMAs a thread a slice
//   against K1's 6912, so each copy is hidden by less work): each stage has
//   a full mbarrier, and the last warp to finish with a stage (a count in
//   shared memory) issues its refill, so no warp waits for the others and
//   no warp is kept for the copies alone (a producer warp would cost its
//   registers: 48-channel blocks would no longer fit two to an SM).
// - Consumer warp g owns output channels 8g..8g+7 of the block and all its
//   voxels: lane l holds box voxels l, l+32, ..., l+224, 8 voxels x 8
//   channels = 64 f32 accumulators.  Per tap and slice it reads its 8
//   voxels' 4 channels (8 16-byte loads) and the 4 x 8 weights (8 16-byte
//   loads of one address a warp, broadcast), then does 256 FMAs.  A voxel's
//   4 channels are one 16-byte record of the halo, and a quarter-warp's 8
//   lanes read 8 consecutive records of one row (bx is a multiple of 8), so
//   no two of them share a bank.  That is why a slice is 4 channels: with
//   wider records a quarter-warp's reads fall two to a bank.
// - Epilogue from registers: the bias, ReLU unless relu = 0, two 16-byte
//   stores per voxel along Co; voxels past the box or the output, and
//   channels past Co, are masked.
// - Every output voxel's sum runs in one order, slice by slice (xa's, then
//   xb's), tap by tap (tz, ty, tx), channel by channel, whatever box or
//   block position holds it: no atomics, no split of K.  So a tile and the
//   whole volume give the same bits.
//
// C entries: fpl_conv3d_f32(...) and fpl_tail_stage_f32(...) encode the
// tensor maps, launch on the given stream and return cudaGetLastError() (or
// cudaErrorInvalidValue for arguments they do not take); they allocate
// nothing and do not synchronise.

#include "hopper.cuh"

namespace {

constexpr int kSlice = 4;                 // input channels per slice
constexpr int kVox = 8;                   // output voxels per thread
constexpr int kBoxVoxels = 32 * kVox;     // output voxels per block, at most
constexpr int kGroup = 8;                 // output channels per consumer warp
constexpr int kConvStages = 2;            // depth of K1's ring (27 taps)
constexpr int kTailStages = 4;            // depth of a tail stage's (8 taps)
constexpr int kTapBytes = kSlice * kGroup * 4;  // a group's weights of a tap
constexpr int kSmemLimit = 226 * 1024;    // dynamic bytes; the barriers are static

struct F32Args {
  int Do, Ho, Wo, Co, d, slices, slices_a, width;
  int bz, by, bx, hy, hx, tiles_z, tiles_y, tiles_x;
  uint32_t halo_bytes, w_bytes, w_off, stage_bytes;
  int relu, vec;
};

__host__ __device__ constexpr uint32_t round_1024(uint32_t v) {
  return (v + 1023u) & ~1023u;
}

// blocks a launch of NG consumer warps should fit on one SM: as many as
// 168 registers a thread allow, up to 4
constexpr int min_blocks(int ng) {
  return ng >= 7 ? 1 : ng >= 5 ? 2 : ng == 4 ? 3 : 4;
}

// one thread issues slice s into stage st: the halo by TMA (from xa's map
// for the first slices_a slices, then from xb's), the weights by a bulk
// copy, both completing on the stage's full barrier
__device__ __forceinline__ void load_slice(const CUtensorMap* tm_a,
                                           const CUtensorMap* tm_b,
                                           const float* w, const F32Args& a,
                                           uint32_t base, uint32_t bar, int s,
                                           int st, int x0, int y0, int z0,
                                           int n) {
  const uint32_t dst = base + st * a.stage_bytes;
  mbar_expect_tx(bar, a.halo_bytes + a.w_bytes);
  if (s < a.slices_a)
    tma_load_5d(dst, tm_a, bar, s * kSlice, x0, y0, z0, n);
  else
    tma_load_5d(dst, tm_b, bar, (s - a.slices_a) * kSlice, x0, y0, z0, n);
  bulk_load(dst + a.w_off, w + (size_t)s * (a.w_bytes / 4), a.w_bytes, bar);
}

// NG consumer warps (8 NG output channels), T taps a side, S stages
template <int NG, int T, int S>
__global__ void __launch_bounds__(32 * NG, min_blocks(NG))
conv_f32_kernel(const __grid_constant__ CUtensorMap tm_a,
                const __grid_constant__ CUtensorMap tm_b,
                const float* __restrict__ wimg, const float* __restrict__ bias,
                float* __restrict__ out, F32Args a) {
  extern __shared__ __align__(1024) uint8_t f32_smem[];
  __shared__ __align__(8) uint64_t full_bar[S];
  __shared__ int released[S];  // consumer warps done with a stage, ever
  // TMA writes the halo to a 128-byte boundary: every stage starts on 1024
  const uint32_t raw = smem_u32(f32_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* sm = f32_smem + (base - raw);

  int t = blockIdx.x;
  const int x0 = (t % a.tiles_x) * a.bx;
  t /= a.tiles_x;
  const int y0 = (t % a.tiles_y) * a.by;
  t /= a.tiles_y;
  const int z0 = (t % a.tiles_z) * a.bz;
  const int n = t / a.tiles_z;
  const int cb = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const float* w = wimg + (size_t)cb * a.slices * (a.w_bytes / 4);

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {  // the ring's first slices
    prefetch_map(&tm_a);
    if (a.slices_a < a.slices) prefetch_map(&tm_b);
    for (int s = 0; s < S && s < a.slices; ++s)
      load_slice(&tm_a, &tm_b, w, a, base, smem_u32(&full_bar[s]), s, s, x0,
                 y0, z0, n);
  }

  const int g = uniform_warp_index();  // the warp's group of 8 channels
  const int box = a.bz * a.by * a.bx;
  // the byte offset in the halo of each of the thread's voxels (box voxel
  // j*32 + lane, x fastest); a voxel past the box reads the first one
  uint32_t hoff[kVox];
#pragma unroll
  for (int j = 0; j < kVox; ++j) {
    const int i = j * 32 + lane;
    int xx = 0, yy = 0, zz = 0;
    if (i < box) {
      xx = i % a.bx;
      const int r = i / a.bx;
      yy = r % a.by;
      zz = r / a.by;
    }
    hoff[j] = (uint32_t)(((zz * a.hy + yy) * a.hx + xx) * 16);
  }
  const uint32_t step_x = a.d * 16, step_y = step_x * a.hx,
                 step_z = step_y * a.hy;

  float acc[kVox][kGroup];
#pragma unroll
  for (int j = 0; j < kVox; ++j)
#pragma unroll
    for (int k = 0; k < kGroup; ++k) acc[j][k] = 0.f;

  for (int s = 0; s < a.slices; ++s) {
    const int st = s % S;
    mbar_wait(smem_u32(&full_bar[st]), (s / S) & 1);
    const uint8_t* xs = sm + st * a.stage_bytes;
    const uint8_t* ws = xs + a.w_off + g * kTapBytes;
#pragma unroll 1
    for (int tz = 0; tz < T; ++tz) {
#pragma unroll 1
      for (int ty = 0; ty < T; ++ty) {
        const uint8_t* xrow = xs + tz * step_z + ty * step_y;
        const uint8_t* wrow = ws + (tz * T + ty) * T * NG * kTapBytes;
#pragma unroll
        for (int tx = 0; tx < T; ++tx) {
          const float4* wp =
              reinterpret_cast<const float4*>(wrow + tx * NG * kTapBytes);
          float wv[kSlice][kGroup];
#pragma unroll
          for (int c = 0; c < kSlice; ++c) {
            const float4 lo = wp[2 * c], hi = wp[2 * c + 1];
            wv[c][0] = lo.x; wv[c][1] = lo.y; wv[c][2] = lo.z; wv[c][3] = lo.w;
            wv[c][4] = hi.x; wv[c][5] = hi.y; wv[c][6] = hi.z; wv[c][7] = hi.w;
          }
          const uint8_t* xt = xrow + tx * step_x;
#pragma unroll
          for (int j = 0; j < kVox; ++j) {
            const float4 v = *reinterpret_cast<const float4*>(xt + hoff[j]);
            const float xv[kSlice] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int c = 0; c < kSlice; ++c)
#pragma unroll
              for (int k = 0; k < kGroup; ++k)
                acc[j][k] = fmaf(xv[c], wv[c][k], acc[j][k]);
          }
        }
      }
    }
    // every lane has read the stage; the last warp to release it refills
    // it with the slice S on (no warp waits for the others)
    if (s + S < a.slices) {
      __syncwarp();
      if (lane == 0) {
        __threadfence_block();
        if (atomicAdd(&released[st], 1) % NG == NG - 1) {
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          load_slice(&tm_a, &tm_b, w, a, base, smem_u32(&full_bar[st]),
                     s + S, st, x0, y0, z0, n);
        }
      }
    }
  }

  // -------------------------------------------------------------- epilogue
  const int o0 = cb * a.width + g * kGroup;  // the warp's first channel
  float bv[kGroup];
#pragma unroll
  for (int k = 0; k < kGroup; ++k) bv[k] = o0 + k < a.Co ? bias[o0 + k] : 0.f;
#pragma unroll
  for (int j = 0; j < kVox; ++j) {
    const int i = j * 32 + lane;
    if (i >= box) continue;
    const int xx = x0 + i % a.bx, r = i / a.bx;
    const int yy = y0 + r % a.by, zz = z0 + r / a.by;
    if (xx >= a.Wo || yy >= a.Ho || zz >= a.Do) continue;
    float* o = out + ((((long long)n * a.Do + zz) * a.Ho + yy) * a.Wo + xx) *
                         a.Co + o0;
    float v[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      v[k] = acc[j][k] + bv[k];
      if (a.relu) v[k] = fmaxf(v[k], 0.f);
    }
    if (a.vec && o0 + kGroup <= a.Co) {
      reinterpret_cast<float4*>(o)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(o)[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
      for (int k = 0; k < kGroup; ++k)
        if (o0 + k < a.Co) o[k] = v[k];
    }
  }
}

// the map of f32 x (B,D,H,W,Ci) read in boxes (4, hx, hy, hz, 1): one
// slice's halo, 16 bytes a voxel, unswizzled, zero past the volume
bool encode_x_f32(EncodeTiled encode, CUtensorMap* map, const void* x, int B,
                  int D, int H, int W, int Ci, int hz, int hy, int hx) {
  const cuuint64_t e = sizeof(float);
  const cuuint64_t dim[5] = {(cuuint64_t)Ci, (cuuint64_t)W, (cuuint64_t)H,
                             (cuuint64_t)D, (cuuint64_t)B};
  const cuuint64_t stride[4] = {Ci * e, (cuuint64_t)W * Ci * e,
                                (cuuint64_t)H * W * Ci * e,
                                (cuuint64_t)D * H * W * Ci * e};
  const cuuint32_t box[5] = {(cuuint32_t)kSlice, (cuuint32_t)hx,
                             (cuuint32_t)hy, (cuuint32_t)hz, 1};
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, const_cast<void*>(x),
                dim, stride, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NG, int T, int S>
int launch(const CUtensorMap& ma, const CUtensorMap& mb, const float* w,
           const float* b, float* out, int B, F32Args a, int n_cb,
           cudaStream_t stream) {
  a.w_bytes = (uint32_t)(T * T * T) * NG * kTapBytes;
  a.w_off = round_1024(a.halo_bytes);
  a.stage_bytes = round_1024(a.w_off + a.w_bytes);
  const long long smem = (long long)S * a.stage_bytes + 1024;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  auto kernel = conv_f32_kernel<NG, T, S>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)B * a.tiles_z * a.tiles_y * a.tiles_x;
  if (blocks > 0x7fffffffLL || n_cb > 65535) return (int)cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)blocks, n_cb), 32 * NG, (size_t)smem,
           stream>>>(ma, mb, w, b, out, a);
  return (int)cudaGetLastError();
}

template <int T, int S>
int dispatch(int ng, const CUtensorMap& ma, const CUtensorMap& mb,
             const float* w, const float* b, float* out, int B,
             const F32Args& a, int n_cb, cudaStream_t s) {
#define FPL_F32_CASE(NG) \
  case NG:               \
    return launch<NG, T, S>(ma, mb, w, b, out, B, a, n_cb, s);
  switch (ng) {
    FPL_F32_CASE(1)
    FPL_F32_CASE(2)
    FPL_F32_CASE(3)
    FPL_F32_CASE(4)
    FPL_F32_CASE(5)
    FPL_F32_CASE(6)
    FPL_F32_CASE(7)
    FPL_F32_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FPL_F32_CASE
}

// both C entries: xa (B,D,H,W,Ca) and, where Cb > 0, xb (B,D,H,W,Cb), f32,
// 16-byte aligned, Ca > 0 and Cb multiples of 4; w the weight image of
// Ca/4 + Cb/4 slices; taps = T (3 at dilation d, or 2 at d = 1)
int run(const void* xa, const void* xb, const void* w, const void* b,
        void* out, int B, int D, int H, int W, int Ca, int Cb, int Co, int d,
        int width, int bz, int by, int bx, int relu, int taps, void* stream) {
  const long long r = (long long)(taps - 1) * d;  // the halo past the box
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (B < 1 || Ca < kSlice || Ca % kSlice || Cb < 0 || Cb % kSlice ||
      Co < 1 || d < 1 || width < 8 || width > 8 * 8 || width % 8 || bz < 1 ||
      by < 1 || bx < 1 || (long long)bz * by * bx > kBoxVoxels ||
      bz + r > 256 || by + r > 256 || bx + r > 256 || D <= r || H <= r ||
      W <= r || !aligned(xa) || !aligned(w) ||
      (Cb > 0 && (xb == nullptr || !aligned(xb))))
    return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const int hz = bz + (int)r, hy = by + (int)r, hx = bx + (int)r;
  CUtensorMap ma, mb;
  if (!encode_x_f32(encode, &ma, xa, B, D, H, W, Ca, hz, hy, hx))
    return (int)cudaErrorInvalidValue;
  mb = ma;  // never read when there is no xb
  if (Cb > 0 && !encode_x_f32(encode, &mb, xb, B, D, H, W, Cb, hz, hy, hx))
    return (int)cudaErrorInvalidValue;

  F32Args a = {};
  a.Do = D - (int)r; a.Ho = H - (int)r; a.Wo = W - (int)r;
  a.Co = Co; a.d = d; a.slices = (Ca + Cb) / kSlice; a.slices_a = Ca / kSlice;
  a.width = width;
  a.bz = bz; a.by = by; a.bx = bx; a.hy = hy; a.hx = hx;
  a.tiles_z = (a.Do + bz - 1) / bz;
  a.tiles_y = (a.Ho + by - 1) / by;
  a.tiles_x = (a.Wo + bx - 1) / bx;
  a.halo_bytes = (uint32_t)(hz * hy * hx * 16);
  a.relu = relu;
  a.vec = Co % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int n_cb = (Co + width - 1) / width;
  const auto* wt = static_cast<const float*>(w);
  const auto* bt = static_cast<const float*>(b);
  auto* ot = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (taps == 3)
    return dispatch<3, kConvStages>(width / 8, ma, mb, wt, bt, ot, B, a, n_cb,
                                    s);
  if (taps == 2 && d == 1)
    return dispatch<2, kTailStages>(width / 8, ma, mb, wt, bt, ot, B, a, n_cb,
                                    s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K1.  x (B,D,H,W,Ci) f32, Ci % 4 == 0, 16-byte aligned.  w: the weight
// image of ops/conv.py::simt_weights, (ceil(Co / width), Ci / 4, 27,
// width / 8, 4, 8) f32, zero past Co, 16-byte aligned.  b (Co,) f32; out
// (B, D-2d, H-2d, W-2d, Co) f32.  width: the output channels of one block,
// a multiple of 8 up to 64 (gridDim.y = ceil(Co / width) blocks); the
// output box bz*by*bx holds at most 256 voxels and its halo (b + 2d on
// each axis) at most 256 on each axis.  relu = 0 leaves the clamp out.  All
// contiguous; shapes are checked by the Python wrapper.
extern "C" int fpl_conv3d_f32(const void* x, const void* w, const void* b,
                              void* out, int B, int D, int H, int W, int Ci,
                              int Co, int d, int width, int bz, int by, int bx,
                              int relu, void* stream) {
  cudaGetLastError();  // clear any earlier, unrelated error
  return run(x, nullptr, w, b, out, B, D, H, W, Ci, 0, Co, d, width, bz, by,
             bx, relu, 3, stream);
}

// A tail stage (K2, K3).  xa (B,D,H,W,Ca) and, with Cb > 0, xb
// (B,D,H,W,Cb) f32, Ca > 0 and Cb multiples of 4, 16-byte aligned.  w: the
// weight image of ops/tail.py::tail_simt_weights, (ceil(Co / width),
// (Ca + Cb) / 4, 8, width / 8, 4, 8) f32, xa's slices then xb's, zero past
// Co, 16-byte aligned.  b (Co,) f32; out (B, D-1, H-1, W-1, Co) f32 =
// relu(conv2(xa, wa) + conv2(xb, wb) + b).  width and the box as for K1,
// the halo b + 1 on each axis.
extern "C" int fpl_tail_stage_f32(const void* xa, const void* xb,
                                  const void* w, const void* b, void* out,
                                  int B, int D, int H, int W, int Ca, int Cb,
                                  int Co, int width, int bz, int by, int bx,
                                  void* stream) {
  cudaGetLastError();  // clear any earlier, unrelated error
  return run(xa, xb, w, b, out, B, D, H, W, Ca, Cb, Co, 1, width, bz, by, bx,
             1, 2, stream);
}
