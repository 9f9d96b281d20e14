// K1's bf16 route for Ci > 1 on Hopper: the valid dilated 3x3x3 conv +
// bias + ReLU as an implicit GEMM on wgmma, fed by TMA through an mbarrier
// ring (sm_90a).
//
// Replaces the TPU kernel flypylib_tpu/ops/pallas_conv.py:155
// (conv3d_bias_relu) for bf16 x (B,D,H,W,Ci) with Ci % 8 == 0, Co % 8 == 0
// and a 16-byte-aligned x; csrc/conv3d_bias_relu.cu keeps every other call.
// It computes, as that kernel does,
//
//   out[n,z,y,x,o] = bf16(relu(sum_{tz,ty,tx,c} f32(x[n, z+tz*d, y+ty*d, x+tx*d, c])
//                                                * f32(w[tz,ty,tx,c,o]) + f32(b[o])))
//
// with f32 accumulation, the f32 bias add, ReLU, then one rounding.  With
// relu = 0 the clamp is left out (a BatchNorm layer's conv, whose ReLU
// follows the normalisation).
//
// The GEMM: M = output voxels, N = Co, K = 27 taps x Ci.
// - A block owns one output box (bz, by, bx) of one batch entry, up to 256
//   rows (bz*by*bx <= 256; the wrapper picks the box that covers the
//   output in the fewest blocks), and the whole of N: the
//   N-tile NT is Co rounded up to one of 24/32/48/64/96/128, so each A
//   tile is loaded once whatever Co is.
// - K runs over (tap, channel slice) steps.  For each step one TMA load of
//   a 5-D box (32, bx, by, bz, 1) at (c0, x0+tx*d, y0+ty*d, z0+tz*d, n)
//   over the NDHWC input is exactly that tap's A tile, K contiguous, 64-byte
//   swizzled; TMA zero-fills channels past Ci and voxels past the volume.
//   Where the channels past the last multiple of 32 are at most 16, they go
//   in one 16-channel slice ending at channel Ci (a (16, bx, by, bz, 1) box
//   with the 32-byte swizzle, one k16 step; the weights of channels an
//   earlier slice holds are zeroed): Ci = 48 moves and multiplies 48
//   channels, not 64.  A rest of 17-31 channels takes one more 32-channel
//   slice, zero-filled past Ci.  (Ci = 24 is the slow case: its 48-byte
//   voxel stride leaves the box rows off the 32- and 64-byte boundaries,
//   and it runs at about half the rate of Ci = 16 or 32 at the same shape;
//   scripts/probe_k1_channels.py times the three.)  A second TMA load
//   brings the step's (NT x 32 or 16) weight slice from the images the
//   wrapper lays out once per call (zero-padded bf16), K-major with the
//   same swizzle.
// - A ring of STAGES (A, B) stages in dynamic shared memory with full and
//   empty mbarriers.  Warp 8 is the producer (one thread issues the TMA
//   loads); warpgroups 0 and 1 are consumers, each owning two m64 row
//   blocks: per step, 2 k16 wgmma per row block (m64nNTk16, both operands
//   from shared memory), then wait_group 1 and release of the step before.
//   The accumulators take NT f32 registers a thread (156 registers in all
//   at NT = 128, no spill).
// - Epilogue from registers: the f32 fragment plus the f32 bias, ReLU
//   unless relu = 0, one rounding to bf16, stored as bf16 pairs along the channel axis; rows
//   past (Do, Ho, Wo) or past the box, and channels past Co, are masked.
//
// What bounds it on an H100: each input value is re-read through L2 by
// every tap that covers it, about 27 times, and each block re-reads the
// weights once per step.  At the baseline's layer 3 that is ~5.4 GB of A
// and ~1.4 GB of B through L2 for 0.35 ms of MMA work, so the kernel is
// L2-bandwidth-bound before it is MMA-bound.  What the design does about
// it: every byte goes by TMA (no registers, no address arithmetic per
// thread), the ring keeps STAGES - 1 steps in flight under the wgmma, the
// N tile covers Co (A is read once per block, not once per N block), and
// 256-row blocks halve the weight re-reads of 128-row ones.  Reusing the
// x-shifted taps out of one shared-memory tile, which would cut A's L2
// traffic about threefold, is later work (the shift breaks the swizzle
// phase the wgmma descriptor assumes, so it needs a different layout).
//
// C entry: fpl_conv3d_wgmma(...) encodes the two tensor maps, launches on
// the given stream and returns cudaGetLastError() (or cudaErrorInvalidValue
// for arguments it does not take); it allocates nothing and does not
// synchronise.

#include "hopper.cuh"

namespace {

constexpr int kStages = 5;         // depth of the ring
constexpr int kConsumers = 256;    // two warpgroups
constexpr int kMW = 2;             // m64 row blocks per consumer warpgroup
constexpr int kRows = 128 * kMW;   // output rows (voxels) per block
constexpr int kThreads = kConsumers + 32;  // + one producer warp

template <int NT>
__global__ void __launch_bounds__(kThreads)
conv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_x16,
                  const __grid_constant__ CUtensorMap tm_w,
                  const __grid_constant__ CUtensorMap tm_w16,
                  const __nv_bfloat16* __restrict__ bias,
                  __nv_bfloat16* __restrict__ out, int Do, int Ho, int Wo,
                  int Co, int ldo, int d, int n_full, int half, int c_last, int bz,
                  int by, int bx,
                  int tiles_z, int tiles_y, int tiles_x, int relu) {
  constexpr int kABytes = kRows * kRowBytes;
  constexpr int kBBytes = NT * kRowBytes;
  constexpr int kStageBytes = kABytes + ((kBBytes + 1023) / 1024) * 1024;
  static_assert(NT % 8 == 0 && NT <= 128, "N tile");

  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];
  // the swizzle pattern repeats every 512 bytes: align every tile to 1024
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;

  int t = blockIdx.x;
  const int ti_x = t % tiles_x;
  t /= tiles_x;
  const int ti_y = t % tiles_y;
  t /= tiles_y;
  const int ti_z = t % tiles_z;
  const int n = t / tiles_z;
  const int x0 = ti_x * bx, y0 = ti_y * by, z0 = ti_z * bz;
  const int per_tap = n_full + half;  // K steps per tap
  const int steps = 27 * per_tap;
  const int tid = threadIdx.x;
  const int warp_id = uniform_warp_index();

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);
      mbar_init(smem_u32(&empty_bar[s]), kConsumers / 32);  // one per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp_id >= kConsumers / 32) {
    // ---------------------------------------------------------- producer
    if (tid == kConsumers) {
      prefetch_map(&tm_x);
      prefetch_map(&tm_w);
      if (half) prefetch_map(&tm_x16), prefetch_map(&tm_w16);
      const int rows = bz * by * bx;
      int tap = 0, sl = 0;
      for (int it = 0; it < steps; ++it) {
        const int s = it % kStages;
        if (it >= kStages)
          mbar_wait(smem_u32(&empty_bar[s]), ((it / kStages) + 1) & 1);
        const int tz = tap / 9, ty = (tap / 3) % 3, tx = tap % 3;
        const uint32_t fb = smem_u32(&full_bar[s]);
        const uint32_t sa = base + s * kStageBytes;
        const bool full = sl < n_full;  // else the 16-channel slice
        const int row = full ? kRowBytes : kRowBytes / 2;
        mbar_expect_tx(fb, (uint32_t)((rows + NT) * row));
        tma_load_5d(sa, full ? &tm_x : &tm_x16, fb, full ? sl * kKC : c_last,
                    x0 + tx * d, y0 + ty * d, z0 + tz * d, n);
        tma_load_2d(sa + kABytes, full ? &tm_w : &tm_w16, fb, 0,
                    (full ? tap * n_full + sl : tap) * NT);
        if (++sl == per_tap) sl = 0, ++tap;
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int wg = warp_id / 4;
  // no zero fill: the first step's wgmma overwrites (scale_d = 0).  A move
  // into the accumulators between wgmma issue and wait would serialise them.
  float acc[kMW][NT / 2];
  int sl = 0;
  for (int it = 0; it < steps; ++it) {
    const int s = it % kStages;
    mbar_wait(smem_u32(&full_bar[s]), (it / kStages) & 1);
    const uint32_t sa = base + s * kStageBytes;
#pragma unroll
    for (int m = 0; m < kMW; ++m) fence_acc(acc[m]);
    wgmma_fence();
    if (sl < n_full) {  // 32 channels: two k16 steps, +32 bytes of K each
      const uint64_t db = desc_k<64>(sa + kABytes);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int m = 0; m < kMW; ++m)
          wgmma_bf16<NT>(acc[m],
                         desc_k<64>(sa + (wg * kMW + m) * 64 * kRowBytes) + 2 * ks,
                         db + 2 * ks, it > 0 || ks > 0);
    } else {  // the 16-channel slice: 32-byte rows, one k16 step
      const uint64_t db = desc_k<32>(sa + kABytes);
#pragma unroll
      for (int m = 0; m < kMW; ++m)
        wgmma_bf16<NT>(acc[m],
                       desc_k<32>(sa + (wg * kMW + m) * 64 * (kRowBytes / 2)),
                       db, it > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the step before has been read: release its stage
#pragma unroll
    for (int m = 0; m < kMW; ++m) fence_acc(acc[m]);
    if (it > 0 && (tid & 31) == 0)
      mbar_arrive(smem_u32(&empty_bar[(it - 1) % kStages]));
    if (++sl == per_tap) sl = 0;
  }
  wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < kMW; ++m) fence_acc(acc[m]);

  // ------------------------------------------------------------- epilogue
  const int warp = warp_id % 4, lane = tid & 31;
  const int box_rows = bz * by * bx;
#pragma unroll
  for (int m = 0; m < kMW; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (wg * kMW + m) * 64 + warp * 16 + h * 8 + lane / 4;
      if (r >= box_rows) continue;
      const int xx = x0 + r % bx, yy = y0 + (r / bx) % by, zz = z0 + r / (bx * by);
      if (xx >= Wo || yy >= Ho || zz >= Do) continue;
      __nv_bfloat16* o =
          out + ((((long long)n * Do + zz) * Ho + yy) * Wo + xx) * ldo;
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
        const int col = j * 8 + (lane % 4) * 2;
        if (col >= Co) continue;
        float v0 = acc[m][4 * j + 2 * h] + __bfloat162float(bias[col]);
        float v1 = acc[m][4 * j + 2 * h + 1] + __bfloat162float(bias[col + 1]);
        if (relu) v0 = fmaxf(v0, 0.f), v1 = fmaxf(v1, 0.f);
        *reinterpret_cast<__nv_bfloat162*>(o + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

struct Maps {
  CUtensorMap x, x16, w, w16;
};

template <int NT>
int launch(const Maps& m, const __nv_bfloat16* b, __nv_bfloat16* out, int B,
           int Do, int Ho, int Wo, int Co, int ldo, int d, int n_full,
           int half, int c_last, int bz, int by, int bx, int relu,
           cudaStream_t stream) {
  constexpr int kABytes = kRows * kRowBytes;
  constexpr int kStageBytes =
      kABytes + ((NT * kRowBytes + 1023) / 1024) * 1024;
  constexpr int kSmem = kStages * kStageBytes + 1024;  // + alignment slack
  if (bz * by * bx > kRows) return (int)cudaErrorInvalidValue;
  auto kernel = conv_wgmma_kernel<NT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  const int tz = (Do + bz - 1) / bz, ty = (Ho + by - 1) / by,
            tx = (Wo + bx - 1) / bx;
  const long long blocks = (long long)B * tz * ty * tx;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, kSmem, stream>>>(
      m.x, m.x16, m.w, m.w16, b, out, Do, Ho, Wo, Co, ldo, d, n_full, half, c_last,
      bz, by, bx, tz, ty, tx, relu);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B,D,H,W,Ci) bf16, 16-byte aligned.  The weights as the wrapper lays
// them out (ops/conv.py::wgmma_weights): w32 (27, n_full, n_tile, 32) for
// the n_full slices of 32 channels (Ci / 32, plus one if the rest is more
// than 16; null if none), w16 (27, n_tile, 16) for the 16-channel slice
// at max(Ci - 16, 0) that holds a rest of 1-16 channels (null if none);
// both bf16, zero past Ci and Co and where a 32-channel slice holds the
// channel.  b (Co,) bf16; out (B, D-2d,
// H-2d, W-2d, ldo) bf16, of which the call writes Co channels starting at
// `out` (ldo >= Co, a multiple of 8: a layer wider than the widest N tile
// runs as one call per block of output channels, each with its own weight
// images, bias and channel offset into out).  n_tile is one of
// 24/32/48/64/96/128 (>= Co); the output box bz*by*bx is at most 256 rows.
// relu = 0 leaves the clamp out.  All contiguous; shapes are checked by
// the Python wrapper.
extern "C" int fpl_conv3d_wgmma(const void* x, const void* w32,
                                const void* w16, const void* b, void* out,
                                int B, int D, int H, int W, int Ci, int Co,
                                int ldo, int d, int n_tile, int bz, int by,
                                int bx, int relu, void* stream) {
  cudaGetLastError();  // clear any earlier, unrelated error
  const int rest = Ci % kKC;
  const int half = rest > 0 && rest <= kKC / 2;
  const int n_full = Ci / kKC + (rest > kKC / 2);
  const int c_last = Ci > kKC / 2 ? Ci - kKC / 2 : 0;
  if (Ci < 8 || Ci % 8 || Co < 8 || Co % 8 || Co > n_tile || ldo < Co ||
      ldo % 8 || d < 1 || bz < 1 ||
      by < 1 || bx < 1 || bz > 256 || by > 256 || bx > 256 ||
      (n_full > 0 && (w32 == nullptr || reinterpret_cast<uintptr_t>(w32) % 16)) ||
      (half && (w16 == nullptr || reinterpret_cast<uintptr_t>(w16) % 16)) ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;

  Maps m = {};  // a map the call does not use stays zero and is never read
  bool ok = true;
  if (n_full > 0)
    ok = encode_x(encode, &m.x, x, B, D, H, W, Ci, kKC, bz, by, bx) &&
         encode_w(encode, &m.w, w32, 27 * n_full * n_tile, kKC, n_tile);
  if (half)
    ok = ok && encode_x(encode, &m.x16, x, B, D, H, W, Ci, kKC / 2, bz, by, bx) &&
         encode_w(encode, &m.w16, w16, 27 * n_tile, kKC / 2, n_tile);
  if (!ok) return (int)cudaErrorInvalidValue;

  const auto* bt = static_cast<const __nv_bfloat16*>(b);
  auto* ot = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Do = D - 2 * d, Ho = H - 2 * d, Wo = W - 2 * d;
#define FPL_WGMMA_CASE(NT)                                               \
  case NT:                                                                 \
    return launch<NT>(m, bt, ot, B, Do, Ho, Wo, Co, ldo, d, n_full, half,      \
                      c_last, bz, by, bx, relu, s);
  switch (n_tile) {
    FPL_WGMMA_CASE(24)
    FPL_WGMMA_CASE(32)
    FPL_WGMMA_CASE(48)
    FPL_WGMMA_CASE(64)
    FPL_WGMMA_CASE(96)
    FPL_WGMMA_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FPL_WGMMA_CASE
}
