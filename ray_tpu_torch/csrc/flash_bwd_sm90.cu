// Flash attention backward for bf16 on Hopper (sm_90a): the dK/dV kernel
// and the dQ kernel, warp-specialised, with TMA loads into a shared-memory
// ring and wgmma products.
//
// Replaces the bf16 path of the Pallas TPU kernels of
// ray_tpu/ops/flash_attention.py:
//   flash_dkdv_sm90_kernel <- _dkdv_kernel (_bwd_pallas, first pallas_call)
//   flash_dq_sm90_kernel   <- _dq_kernel   (_bwd_pallas, second pallas_call)
// beside the mma.sync kernels of flash_attention.cu, which keep the f32
// inputs. Same contract: q, dO [B, Sq, H, D] and k, v [B, Sk, H, D] bf16,
// contiguous; LSE and delta [B, H, Sq] f32 (LSE in natural units); dK, dV
// [B, Sk, H, D] and dQ [B, Sq, H, D] bf16. End-aligned causality (offset =
// Sk - Sq): query row i sees keys <= i + offset. P is recomputed from the
// LSE (masked entries are 0), dS = P * (dP - delta) * scale; accumulators
// are f32, and P and dS are rounded to bf16 for the tensor-core products,
// as the mma.sync kernels do (the TPU kernels kept them in f32).
//
// What bounds them on the H100: operations. dK/dV does 8 * D flops per
// visible (row, key) pair (S^T, dP^T, dV, dK) and dQ 6 * D (S, dP, dQ),
// against a few bytes per pair: at the trainer's shape about 1000 flop/B,
// far above the ~295 flop/B where bf16 tensor cores become the limit.
// Only wgmma reaches the card's tensor-core rate, so both kernels take the
// forward's design (flash_fwd_sm90.cu): warpgroup 0 is a producer whose
// one thread keeps TMA loads in flight in a 2-stage ring guarded by full
// and empty mbarriers (setmaxnreg 24); the consumer warpgroups run wgmma
// from 128-byte-swizzled shared memory (setmaxnreg 240). Each kernel keeps
// its own pass, as the TPU kernels do, so neither needs atomics and both
// are deterministic.
//
// dK/dV: one block of three warpgroups per (64-key tile, head, batch). K
// and V of the tile are loaded once; 64-row Q and dO tiles come through
// the ring (D = 256: K, V 2 x 32 KB + ring 2 x 64 KB + exchange 32 KB =
// 225 KB). Per q tile each consumer computes S^T = K Q^T and dP^T = V dO^T
// (wgmma m64n32k16, both operands K-major) for 32 of the 64 q columns,
// forms P^T and dS^T in f32 registers, and writes them as bf16 into a
// swizzled exchange buffer (double-buffered, so one named barrier a tile
// separates writes from reads). Consumer 0 then accumulates dV += P^T dO
// and consumer 1 dK += dS^T Q over all 64 q rows (wgmma m64nDk16, A
// K-major and B MN-major, both from shared memory), each in 128 f32
// registers at D = 256; the ring slot is released after the product.
// Causal: q tiles wholly above the diagonal are never loaded, and the low
// key tiles, which loop over the most q tiles, launch first.
//
// dQ: one block per (q tile of 64 x kDqCons rows, head, batch). Q and dO
// are loaded once; K and V tiles of kDqBK keys come through the ring (D =
// 256: Q, dO 2 x 64 KB + ring 2 x 32 KB = 192 KB). Each consumer
// warpgroup owns 64 rows: S = Q K^T and dP = dO V^T (wgmma, both operands
// K-major), P and dS in f32 registers, dQ += dS K (wgmma m64nDk16 with dS
// rounded to bf16 in registers as the A operand and K the MN-major B
// operand, the forward's P.V with K in V's place). Causal: key tiles above
// the diagonal are never loaded, and the high q tiles launch first.
//
// Both: TMA zero-fills head-dim columns >= D (D pads to 64, 128 or 256),
// rows >= Sq and keys >= Sk; a zero-filled row still gives S = 0, so keys
// >= Sk, rows >= Sq and the causal mask are applied to P explicitly, on the
// tiles that cross an edge. Tensor maps are encoded on the host on every
// call (no device work, so a CUDA graph can capture the launch) and passed
// as __grid_constant__ parameters. The primitives are in sm90.cuh.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRowBytes = 128;        // one swizzled box row: 64 bf16 columns
constexpr int kBox64 = 64 * kRowBytes;   // one TMA box of 64 rows
constexpr int kConsumerBar = 1;       // named barrier of the dK/dV consumers
// dK/dV
constexpr int kKvBK = 64;             // keys per block
constexpr int kKvBQ = 64;             // q rows per ring stage
constexpr int kKvStages = 2;          // ring depth
constexpr int kKvThreads = 384;       // producer + two consumer warpgroups
// dQ
constexpr int kDqCons = 2;            // consumer warpgroups of 64 rows
constexpr int kDqBK = 32;             // keys per ring stage (S and dP are m64n32)
constexpr int kDqStages = 2;          // ring depth
constexpr int kDqThreads = 128 * (1 + kDqCons);

struct Shape {
  int Sq, Sk, H, D, causal, n_tiles;   // n_tiles: blocks along the grid's z
  float scale, scale_log2;             // softmax scale, and x log2(e)
};

// Shared memory of one block, in bytes from a 1024-aligned base (the
// 128-byte swizzle repeats every 1024 bytes; every box starts on that
// boundary).
template <int HD>
struct DkvSmem {
  static constexpr int NC = HD / 64;                  // boxes per row tile
  static constexpr int tile = NC * kBox64;            // 64 rows x HD columns
  static constexpr int k = 0;
  static constexpr int v = k + tile;
  static constexpr int q = v + tile;                  // [stage][tile]
  static constexpr int dout = q + kKvStages * tile;   // [stage][tile]
  static constexpr int x = dout + kKvStages * tile;     // [buffer][P^T, dS^T][64 x 64]
  static constexpr int bar = x + 4 * kBox64;          // mbarriers
  static constexpr int bytes = bar + 64 + 1024;       // + base alignment
};

template <int HD>
struct DqSmem {
  static constexpr int NC = HD / 64;
  static constexpr int kv_box = kDqBK * kRowBytes;    // one box of a K or V tile
  static constexpr int q = 0;                         // [consumer][NC][box]
  static constexpr int dout = q + kDqCons * NC * kBox64;
  static constexpr int k = dout + kDqCons * NC * kBox64;   // [stage][NC][kv_box]
  static constexpr int v = k + kDqStages * NC * kv_box;      // [stage][NC][kv_box]
  static constexpr int bar = v + kDqStages * NC * kv_box;
  static constexpr int bytes = bar + 64 + 1024;
};

// ----------------------------------------------------------------- dK/dV
// Accumulator layout of wgmma m64nN (f32), thread (warp w, lane = 4g + t)
// of the warpgroup: element 4j + e is row 16w + g + 8 (e >> 1), column
// 8j + 2t + (e & 1). Here the rows are keys and, for S^T and dP^T, the
// columns are q rows.
template <int HD>
__global__ void __launch_bounds__(kKvThreads, 1)
flash_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                       Shape sh) {
  using L = DkvSmem<HD>;
  constexpr int NC = L::NC;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = base + L::bar;        // full[s] at full0 + 8 s
  const uint32_t empty0 = full0 + 8 * kKvStages; // empty[s]
  const uint32_t kvbar = empty0 + 8 * kKvStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kKvBK;           // low key tiles (the heaviest) first
  const int offset = sh.Sk - sh.Sq;
  const int first_qt = sh.causal ? max(0, k0 - offset) / kKvBQ : 0;
  const int n_it = (sh.Sq + kKvBQ - 1) / kKvBQ - first_qt;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kKvStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 256);   // every consumer thread releases
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      mbar_expect_tx(kvbar, 2 * L::tile);
      for (int c = 0; c < NC; ++c) {
        tma_load_4d(base + L::k + c * kBox64, &tk, kvbar, c * 64, h, k0, b);
        tma_load_4d(base + L::v + c * kBox64, &tv, kvbar, c * 64, h, k0, b);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kKvStages;
        const int q0 = (first_qt + it) * kKvBQ;
        mbar_wait(empty0 + 8 * s, ((it / kKvStages) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, 2 * L::tile);
        for (int c = 0; c < NC; ++c) {
          tma_load_4d(base + L::q + s * L::tile + c * kBox64, &tq, full0 + 8 * s, c * 64,
                      h, q0, b);
          tma_load_4d(base + L::dout + s * L::tile + c * kBox64, &tdo, full0 + 8 * s,
                      c * 64, h, q0, b);
        }
      }
    }
  } else {
    // ---------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    // consumer w forms P^T and dS^T for q columns 32 w .. 32 w + 31 of each
    // tile, then accumulates dV (w = 0) or dK (w = 1) over all 64
    const int w = wg - 1;
    const int ctid = tid & 127;
    const int warp = ctid >> 5, lane = ctid & 31, g = lane >> 2, t = lane & 3;
    const int kr0 = 16 * warp + g;   // this thread's key rows: kr0, kr0 + 8
    const float* lse_bh = lse + ((size_t)b * sh.H + h) * sh.Sq;
    const float* delta_bh = delta + ((size_t)b * sh.H + h) * sh.Sq;

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    mbar_wait(kvbar, 0);

    for (int it = 0; it < n_it; ++it) {
      const int s = it % kKvStages;
      const int qc0 = (first_qt + it) * kKvBQ + 32 * w;   // first q row of this half
      // LSE (log2 units) and delta of this thread's 8 columns 8 j + 2 t + e
      float l2[8], dl[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = qc0 + 8 * (i >> 1) + 2 * t + (i & 1);
        const bool in = row < sh.Sq;
        l2[i] = in ? lse_bh[row] * kLog2e : 0.f;
        dl[i] = in ? delta_bh[row] : 0.f;
      }
      mbar_wait(full0 + 8 * s, (it / kKvStages) & 1);
      const uint32_t qs = base + L::q + s * L::tile;
      const uint32_t dos = base + L::dout + s * L::tile;

      // S^T = K Q^T and dP^T = V dO^T on this half's 32 columns
      float st[16], dpt[16];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk >> 2) * kBox64 + (kk & 3) * 32;
        wgmma_ss_m64n32(st, desc_sw128(base + L::k + off, 16, 1024),
                        desc_sw128(qs + off + 32 * w * kRowBytes, 16, 1024), kk > 0);
      }
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk >> 2) * kBox64 + (kk & 3) * 32;
        wgmma_ss_m64n32(dpt, desc_sw128(base + L::v + off, 16, 1024),
                        desc_sw128(dos + off + 32 * w * kRowBytes, 16, 1024), kk > 0);
      }
      wg_commit();

      // P^T from the LSE while dP^T is still in flight
      wg_wait<1>();
      fence_regs(st);
      const bool edge = k0 + kKvBK > sh.Sk || qc0 + 32 > sh.Sq ||
                        (sh.causal && k0 + kKvBK - 1 > qc0 + offset);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int c = ((i >> 2) << 1) | (i & 1);
        float p = exp2f(st[i] * sh.scale_log2 - l2[c]);
        if (edge) {
          const int key = k0 + kr0 + 8 * ((i >> 1) & 1);
          const int row = qc0 + 8 * (i >> 2) + 2 * t + (i & 1);
          if (key >= sh.Sk || row >= sh.Sq || (sh.causal && key > row + offset)) p = 0.f;
        }
        st[i] = p;
      }
      wg_wait<0>();
      fence_regs(dpt);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int c = ((i >> 2) << 1) | (i & 1);
        dpt[i] = st[i] * (dpt[i] - dl[c]) * sh.scale;
      }

      // P^T and dS^T as bf16 into exchange buffer it % 2, rows = keys,
      // 128-byte swizzled: chunk (4 w + j) of row kr at chunk (4 w + j) ^ (kr % 8)
      const uint32_t xb = base + L::x + (it & 1) * 2 * kBox64;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int kr = kr0 + 8 * hr;   // kr % 8 == g
          const uint32_t addr = kr * kRowBytes + (((4 * w + j) ^ g) << 4) + 4 * t;
          const int i = 4 * j + 2 * hr;
          st_shared_u32(xb + addr, pack_bf16(st[i], st[i + 1]));
          st_shared_u32(xb + kBox64 + addr, pack_bf16(dpt[i], dpt[i + 1]));
        }
      }
      fence_proxy_async();
      bar_sync(kConsumerBar, 256);

      // dV += P^T dO (w = 0) or dK += dS^T Q (w = 1), 16 q rows a step
      const uint32_t a_op = xb + w * kBox64;
      const uint32_t b_op = w == 0 ? dos : qs;
      fence_regs(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kKvBQ / 16; ++kk)
        wgmma_ss_tb<HD>(acc, desc_sw128(a_op + kk * 32, 16, 1024),
                        desc_sw128(b_op + kk * 16 * kRowBytes, kBox64, 1024));
      wg_commit();
      wg_wait_all();
      fence_regs(acc);
      mbar_arrive(empty0 + 8 * s);
    }

    // epilogue: keys k0 + kr0 (+ 8), columns 8 j + 2 t (+ 1)
    __nv_bfloat16* out = w == 0 ? dv : dk;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int key = k0 + kr0 + 8 * hr;
      if (key >= sh.Sk) continue;
      __nv_bfloat16* orow = out + (((size_t)b * sh.Sk + key) * sh.H + h) * sh.D;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int col = 8 * j + 2 * t;
        if (col < sh.D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
      }
    }
  }
}

// -------------------------------------------------------------------- dQ
template <int HD>
__global__ void __launch_bounds__(kDqThreads, 1)
flash_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dq, Shape sh) {
  using L = DqSmem<HD>;
  constexpr int NC = L::NC;
  constexpr int kBQ = 64 * kDqCons;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = base + L::bar;
  const uint32_t empty0 = full0 + 8 * kDqStages;
  const uint32_t qbar = empty0 + 8 * kDqStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (sh.n_tiles - 1 - (int)blockIdx.z) * kBQ;   // heaviest first
  const int offset = sh.Sk - sh.Sq;
  const int last_row = min(q0 + kBQ, sh.Sq) - 1;
  int n_kt = (sh.Sk + kDqBK - 1) / kDqBK;
  if (sh.causal) n_kt = min(n_kt, (last_row + offset) / kDqBK + 1);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 128 * kDqCons);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      mbar_expect_tx(qbar, 2 * kDqCons * NC * kBox64);
      for (int half = 0; half < kDqCons; ++half)
        for (int c = 0; c < NC; ++c) {
          const int box = (half * NC + c) * kBox64;
          tma_load_4d(base + L::q + box, &tq, qbar, c * 64, h, q0 + half * 64, b);
          tma_load_4d(base + L::dout + box, &tdo, qbar, c * 64, h, q0 + half * 64, b);
        }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kDqStages;
        mbar_wait(empty0 + 8 * s, ((kt / kDqStages) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, 2 * NC * L::kv_box);
        for (int c = 0; c < NC; ++c) {
          const int box = (s * NC + c) * L::kv_box;
          tma_load_4d(base + L::k + box, &tk, full0 + 8 * s, c * 64, h, kt * kDqBK, b);
          tma_load_4d(base + L::v + box, &tv, full0 + 8 * s, c * 64, h, kt * kDqBK, b);
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
    const uint32_t qs = base + L::q + w * NC * kBox64;
    const uint32_t dos = base + L::dout + w * NC * kBox64;
    float l2[2], dl[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + 8 * hr;
      const size_t idx = ((size_t)b * sh.H + h) * sh.Sq + row;
      l2[hr] = row < sh.Sq ? lse[idx] * kLog2e : 0.f;
      dl[hr] = row < sh.Sq ? delta[idx] : 0.f;
    }

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    mbar_wait(qbar, 0);

    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % kDqStages;
      const int k0 = kt * kDqBK;
      mbar_wait(full0 + 8 * s, (kt / kDqStages) & 1);
      // a tile wholly above this warpgroup's diagonal is skipped (the
      // other warpgroup may still need it)
      if (!sh.causal || k0 <= wg_row0 + 63 + offset) {
        const uint32_t ks = base + L::k + s * NC * L::kv_box;
        const uint32_t vs = base + L::v + s * NC * L::kv_box;
        // S = Q K^T and dP = dO V^T
        float sc[kDqBK / 2], dp[kDqBK / 2];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t off_q = (kk >> 2) * kBox64 + (kk & 3) * 32;
          const uint32_t off_k = (kk >> 2) * L::kv_box + (kk & 3) * 32;
          wgmma_ss_m64n32(sc, desc_sw128(qs + off_q, 16, 1024),
                          desc_sw128(ks + off_k, 16, 1024), kk > 0);
        }
        wg_commit();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t off_q = (kk >> 2) * kBox64 + (kk & 3) * 32;
          const uint32_t off_k = (kk >> 2) * L::kv_box + (kk & 3) * 32;
          wgmma_ss_m64n32(dp, desc_sw128(dos + off_q, 16, 1024),
                          desc_sw128(vs + off_k, 16, 1024), kk > 0);
        }
        wg_commit();

        // P from the LSE while dP is still in flight
        wg_wait<1>();
        fence_regs(sc);
        const bool edge = k0 + kDqBK > sh.Sk || wg_row0 + 64 > sh.Sq ||
                          (sh.causal && k0 + kDqBK - 1 > wg_row0 + offset);
#pragma unroll
        for (int i = 0; i < kDqBK / 2; ++i) {
          const int hr = (i >> 1) & 1;
          float p = exp2f(sc[i] * sh.scale_log2 - l2[hr]);
          if (edge) {
            const int row = row0 + 8 * hr;
            const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
            if (col >= sh.Sk || row >= sh.Sq || (sh.causal && col > row + offset)) p = 0.f;
          }
          sc[i] = p;
        }
        wg_wait<0>();
        fence_regs(dp);
        // dS, rounded to bf16 as the A operand of dQ += dS K
        uint32_t a[kDqBK / 16][4];
#pragma unroll
        for (int kk = 0; kk < kDqBK / 16; ++kk) {
          float d8[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int i = 8 * kk + e;
            d8[e] = sc[i] * (dp[i] - dl[(i >> 1) & 1]) * sh.scale;
          }
          a[kk][0] = pack_bf16(d8[0], d8[1]);
          a[kk][1] = pack_bf16(d8[2], d8[3]);
          a[kk][2] = pack_bf16(d8[4], d8[5]);
          a[kk][3] = pack_bf16(d8[6], d8[7]);
        }

        // dQ += dS K, K the MN-major B operand (16 keys a step)
        fence_regs(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kDqBK / 16; ++kk)
          wgmma_pv<HD>(acc, a[kk], desc_sw128(ks + kk * 16 * kRowBytes, L::kv_box, 1024));
        wg_commit();
        wg_wait_all();
        fence_regs(acc);
      }
      mbar_arrive(empty0 + 8 * s);
    }

    // epilogue: rows row0 (+ 8), columns 8 j + 2 t (+ 1)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + 8 * hr;
      if (row >= sh.Sq) continue;
      __nv_bfloat16* orow = dq + (((size_t)b * sh.Sq + row) * sh.H + h) * sh.D;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int col = 8 * j + 2 * t;
        if (col < sh.D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
      }
    }
  }
}

// ------------------------------------------------------------------ host
// Raise a kernel's dynamic shared memory cap once per instantiation.
template <typename K>
int allow_smem(K kernel, int bytes, bool& done) {
  if (done) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done = true;
  return (int)e;
}

// Tensor maps of q, k, v, dO; K and V tiles have `kv_rows` rows.
int encode_all(CUtensorMap* m, const void* q, const void* k, const void* v,
               const void* dout, int B, int Sq, int Sk, int H, int D, int kv_rows) {
  int err = encode(&m[0], q, B, Sq, H, D);
  if (!err) err = encode(&m[1], k, B, Sk, H, D, kv_rows);
  if (!err) err = encode(&m[2], v, B, Sk, H, D, kv_rows);
  if (!err) err = encode(&m[3], dout, B, Sq, H, D);
  return err;
}

template <int HD>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dk, void* dv, int B, int Sq,
                int Sk, int H, int D, float scale, int causal, cudaStream_t stream) {
  CUtensorMap m[4];
  const int err = encode_all(m, q, k, v, dout, B, Sq, Sk, H, D, 64);
  if (err) return err;
  auto kern = flash_dkdv_sm90_kernel<HD>;
  static bool smem_set = false;
  const int e = allow_smem(kern, DkvSmem<HD>::bytes, smem_set);
  if (e) return e;
  const int n_kt = (Sk + kKvBK - 1) / kKvBK;
  const Shape sh{Sq, Sk, H, D, causal, n_kt, scale, scale * kLog2e};
  kern<<<dim3(H, B, n_kt), kKvThreads, DkvSmem<HD>::bytes, stream>>>(
      m[0], m[1], m[2], m[3], lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), sh);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int Sq, int Sk,
              int H, int D, float scale, int causal, cudaStream_t stream) {
  CUtensorMap m[4];
  const int err = encode_all(m, q, k, v, dout, B, Sq, Sk, H, D, kDqBK);
  if (err) return err;
  auto kern = flash_dq_sm90_kernel<HD>;
  static bool smem_set = false;
  const int e = allow_smem(kern, DqSmem<HD>::bytes, smem_set);
  if (e) return e;
  const int n_qt = (Sq + 64 * kDqCons - 1) / (64 * kDqCons);
  const Shape sh{Sq, Sk, H, D, causal, n_qt, scale, scale * kLog2e};
  kern<<<dim3(H, B, n_qt), kDqThreads, DqSmem<HD>::bytes, stream>>>(
      m[0], m[1], m[2], m[3], lse, delta, static_cast<__nv_bfloat16*>(dq), sh);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). bf16 only. Each returns a
// cudaError_t (0 = success). The caller has checked: D % 8 == 0, D <= 256,
// Sk >= Sq when causal, all tensors contiguous on one sm_90 device and
// 16-byte aligned.
extern "C" int flash_dkdv_sm90(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse, const float* delta,
                               void* dk, void* dv, int B, int Sq, int Sk, int H, int D,
                               float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 0 || D % 8 || D > 256) return (int)cudaErrorInvalidValue;
  if (D <= 64)
    return launch_dkdv<64>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, D, scale,
                           causal, s);
  if (D <= 128)
    return launch_dkdv<128>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, D, scale,
                            causal, s);
  return launch_dkdv<256>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, D, scale,
                          causal, s);
}

extern "C" int flash_dq_sm90(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse, const float* delta,
                             void* dq, int B, int Sq, int Sk, int H, int D, float scale,
                             int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 0 || D % 8 || D > 256) return (int)cudaErrorInvalidValue;
  if (D <= 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, D, scale, causal, s);
  if (D <= 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, D, scale, causal, s);
  return launch_dq<256>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, D, scale, causal, s);
}

// Dynamic shared memory of each kernel at head dim D, in bytes (kernel 0:
// dK/dV, 1: dQ), for the build report.
extern "C" int flash_bwd_sm90_smem(int kernel, int D) {
  const int hd = D <= 64 ? 64 : D <= 128 ? 128 : 256;
  if (kernel == 0)
    return hd == 64 ? DkvSmem<64>::bytes : hd == 128 ? DkvSmem<128>::bytes
                                                     : DkvSmem<256>::bytes;
  return hd == 64 ? DqSmem<64>::bytes : hd == 128 ? DqSmem<128>::bytes : DqSmem<256>::bytes;
}
