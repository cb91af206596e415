// Flash attention forward for bf16 on Hopper (sm_90a): warp-specialised,
// with TMA loads into a shared-memory ring and wgmma products.
//
// Replaces the bf16 path of ray_tpu/ops/flash_attention.py::_fwd_kernel
// (_fwd_pallas), beside the mma.sync kernel of flash_attention.cu, which
// keeps the f32 inputs. Same contract: q [B, Sq, H, D], k, v [B, Sk, H, D]
// bf16, contiguous; O [B, Sq, H, D] bf16 and LSE [B, H, Sq] f32 =
// m + log(l) in natural units; end-aligned causality (offset = Sk - Sq):
// query row i sees keys <= i + offset; masked scores take the TPU
// kernel's finite -1e30; P is rounded to bf16 before P.V.
//
// What bounds it on the H100: operations (4 * D flops per visible (row,
// key) pair against a few bytes per pair: about 1000 flop/B at the
// trainer's shape, far above the ~295 flop/B where bf16 tensor cores
// become the limit). Only wgmma reaches the card's tensor-core rate, so:
// - one block of three warpgroups per (q tile of 128 rows, head, batch).
//   Warpgroup 0 is the producer: one thread issues TMA loads and the
//   warpgroup gives its registers away (setmaxnreg 24). Warpgroups 1 and
//   2 are consumers of 64 q rows each (setmaxnreg 240): the O accumulator
//   of 64 x 256 f32 is 128 registers a thread;
// - TMA tensor maps over q, k, v in their [B, S, H, D] layout (4-D: D, H,
//   S, B) with a box of 64 columns x 64 rows and 128-byte swizzle, so a
//   tile of D = 256 is four 8 KB boxes. Columns >= D and rows past the
//   end are zero-filled by TMA, which pads the head dim to the next of
//   {64, 128, 256} and takes ragged S. Q is loaded once; K and V go
//   through a 2-stage ring of 64-key tiles guarded by full and empty
//   mbarriers (D = 256: Q 64 KB + K 2 x 32 KB + V 2 x 32 KB = 192 KB);
// - S = Q K^T is wgmma m64n64k16 with both operands K-major in shared
//   memory; the online softmax runs in f32 registers (exp2 with the scale
//   folded in); O += P V is wgmma m64nDk16 with P rounded to bf16 in
//   registers as the A operand and V the MN-major B operand;
// - causal: k tiles above the diagonal are never loaded, and the q tiles
//   launch heaviest first (the tile index is the slowest grid axis,
//   reversed), so the long tiles do not form a tail.
// Tensor maps are encoded on the host on every call (no device work, so a
// CUDA graph can capture the launch) with cuTensorMapEncodeTiled, found
// through cudaGetDriverEntryPoint (no -lcuda), and passed as
// __grid_constant__ kernel parameters. The primitives (mbarriers, TMA,
// wgmma descriptors and products, the tensor-map encoder) are in sm90.cuh,
// shared with the backward (flash_bwd_sm90.cu).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;   // the TPU kernel's finite mask value
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kBQ = 128;            // q rows per block (two consumer warpgroups)
constexpr int kBK = 64;             // keys per K/V tile
constexpr int kStages = 2;          // K/V ring depth
constexpr int kBoxBytes = 64 * 128; // one TMA box: 64 rows x 64 bf16 columns
constexpr int kThreads = 384;       // producer + two consumer warpgroups

struct Shape {
  int Sq, Sk, H, D, causal, n_qt;
  float scale_log2;   // softmax scale x log2(e)
};

// Shared memory of one block, in bytes from a 1024-aligned base (the
// 128-byte swizzle repeats every 1024 bytes, and the wgmma descriptors
// assume atoms that start on that boundary).
template <int HD>
struct Smem {
  static constexpr int NC = HD / 64;                        // boxes per row tile
  static constexpr int q = 0;                               // [2 halves][NC][box]
  static constexpr int k = q + 2 * NC * kBoxBytes;          // [stage][NC][box]
  static constexpr int v = k + kStages * NC * kBoxBytes;    // [stage][NC][box]
  static constexpr int bar = v + kStages * NC * kBoxBytes;  // mbarriers
  static constexpr int bytes = bar + 64 + 1024;             // + base alignment
};

// ---------------------------------------------------------------- kernel
// Accumulator layout of wgmma m64nN (f32), thread (warp w, lane = 4g + t)
// of the warpgroup: element 4j + e is row 16w + g + 8 (e >> 1), column
// 8j + 2t + (e & 1) -- the mma.sync C layout repeated over n-tiles j. The
// A operand from registers (m64k16) is the mma.sync A layout per warp.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      Shape sh) {
  using L = Smem<HD>;
  constexpr int NC = L::NC;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = base + L::bar;        // full[s] at full0 + 8 s
  const uint32_t empty0 = full0 + 8 * kStages; // empty[s]
  const uint32_t qbar = empty0 + 8 * kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (sh.n_qt - 1 - (int)blockIdx.z) * kBQ;   // heaviest first
  const int offset = sh.Sk - sh.Sq;
  const int last_row = min(q0 + kBQ, sh.Sq) - 1;
  int n_kt = (sh.Sk + kBK - 1) / kBK;
  if (sh.causal) n_kt = min(n_kt, (last_row + offset) / kBK + 1);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 256);   // every consumer thread releases
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      mbar_expect_tx(qbar, 2 * NC * kBoxBytes);
      for (int half = 0; half < 2; ++half)
        for (int c = 0; c < NC; ++c)
          tma_load_4d(base + L::q + (half * NC + c) * kBoxBytes, &tq, qbar, c * 64, h,
                      q0 + half * 64, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        mbar_wait(empty0 + 8 * s, ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, 2 * NC * kBoxBytes);
        for (int c = 0; c < NC; ++c) {
          tma_load_4d(base + L::k + (s * NC + c) * kBoxBytes, &tk, full0 + 8 * s, c * 64,
                      h, kt * kBK, b);
          tma_load_4d(base + L::v + (s * NC + c) * kBoxBytes, &tv, full0 + 8 * s, c * 64,
                      h, kt * kBK, b);
        }
      }
    }
  } else {
    // ---------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int w = wg - 1;                    // rows q0 + 64 w ..
    const int ctid = tid & 127;
    const int warp = ctid >> 5, lane = ctid & 31, g = lane >> 2, t = lane & 3;
    const int wg_row0 = q0 + 64 * w;
    const int row0 = wg_row0 + 16 * warp + g;   // this thread's rows: row0, row0 + 8
    const uint32_t qs = base + L::q + w * NC * kBoxBytes;

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    mbar_wait(qbar, 0);

    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % kStages;
      const int k0 = kt * kBK;
      mbar_wait(full0 + 8 * s, (kt / kStages) & 1);
      // a tile wholly above this warpgroup's diagonal is skipped (the
      // other warpgroup may still need it)
      if (!sh.causal || k0 <= wg_row0 + 63 + offset) {
        // S = Q K^T
        float sc[32];
        const uint32_t ks = base + L::k + s * NC * kBoxBytes;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t off = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
          wgmma_ss_m64n64(sc, desc_sw128(qs + off, 16, 1024),
                          desc_sw128(ks + off, 16, 1024), kk > 0);
        }
        wg_commit();
        wg_wait_all();
        fence_regs(sc);

        // scale (log2 units), mask, online softmax
        const bool edge = k0 + kBK > sh.Sk ||
                          (sh.causal && k0 + kBK - 1 > wg_row0 + offset);
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          float x = sc[i] * sh.scale_log2;
          if (edge) {
            const int row = row0 + 8 * ((i >> 1) & 1);
            const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
            if (col >= sh.Sk || (sh.causal && col > row + offset)) x = kNegInf;
          }
          sc[i] = x;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
        }
        float alpha[2];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float m_new = fmaxf(m[hr], quad_max(mx[hr]));
          alpha[hr] = exp2f(m[hr] - m_new);
          m[hr] = m_new;
        }
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          sc[i] = exp2f(sc[i] - m[(i >> 1) & 1]);
          rs[(i >> 1) & 1] += sc[i];
        }
        l[0] = alpha[0] * l[0] + rs[0];   // per-thread partial; quad sum at the end
        l[1] = alpha[1] * l[1] + rs[1];
        uint32_t pa[kBK / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const float* c0 = sc + 8 * kk;       // n-tile 2 kk: keys 16 kk ..
          const float* c1 = sc + 8 * kk + 4;   // n-tile 2 kk + 1
          pa[kk][0] = pack_bf16(c0[0], c0[1]);
          pa[kk][1] = pack_bf16(c0[2], c0[3]);
          pa[kk][2] = pack_bf16(c1[0], c1[1]);
          pa[kk][3] = pack_bf16(c1[2], c1[3]);
        }
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

        // O += P V
        const uint32_t vs = base + L::v + s * NC * kBoxBytes;
        fence_regs(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_pv<HD>(acc, pa[kk], desc_sw128(vs + kk * 16 * 128, kBoxBytes, 1024));
        wg_commit();
        wg_wait_all();
        fence_regs(acc);
      }
      mbar_arrive(empty0 + 8 * s);
    }

    // epilogue: O = acc / l (l == 0 guarded), LSE = m ln 2 + log(l)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float lv0 = quad_sum(l[hr]);
      const int row = row0 + 8 * hr;
      if (row >= sh.Sq) continue;
      const float lv = lv0 == 0.f ? 1.f : lv0;
      const float inv = 1.f / lv;
      __nv_bfloat16* orow = o + (((size_t)b * sh.Sq + row) * sh.H + h) * sh.D;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int col = 8 * j + 2 * t;
        if (col < sh.D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * hr] * inv, acc[4 * j + 2 * hr + 1] * inv);
      }
      if (t == 0) lse[((size_t)b * sh.H + h) * sh.Sq + row] = m[hr] * kLn2 + logf(lv);
    }
  }
}

// ------------------------------------------------------------------ host
template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
           int Sq, int Sk, int H, int D, float scale, int causal, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int err = encode(&mq, q, B, Sq, H, D);
  if (!err) err = encode(&mk, k, B, Sk, H, D);
  if (!err) err = encode(&mv, v, B, Sk, H, D);
  if (err) return err;
  auto kern = flash_fwd_sm90_kernel<HD>;
  constexpr int smem = Smem<HD>::bytes;
  static bool smem_set = false;   // per instantiation
  if (!smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const Shape sh{Sq, Sk, H, D, causal, n_qt, scale * 1.4426950408889634f};
  kern<<<dim3(H, B, n_qt), kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, sh);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). bf16 only. Returns a
// cudaError_t (0 = success). The caller has checked: D % 8 == 0, D <= 256,
// Sk >= Sq when causal, all tensors contiguous on one sm_90 device and
// 16-byte aligned.
extern "C" int flash_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                              float* lse, int B, int Sq, int Sk, int H, int D,
                              float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 0 || D % 8 || D > 256) return (int)cudaErrorInvalidValue;
  if (D <= 64) return launch<64>(q, k, v, o, lse, B, Sq, Sk, H, D, scale, causal, s);
  if (D <= 128) return launch<128>(q, k, v, o, lse, B, Sq, Sk, H, D, scale, causal, s);
  return launch<256>(q, k, v, o, lse, B, Sq, Sk, H, D, scale, causal, s);
}
