// Flash attention for f32 inputs (forward, dK/dV, dQ) and the delta
// kernel for both dtypes, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of ray_tpu/ops/flash_attention.py:
//   flash_fwd_kernel   <- _fwd_kernel   (_fwd_pallas)
//   flash_delta_kernel <- _delta_kernel (_delta_pallas)
//   flash_dkdv_kernel  <- _dkdv_kernel  (_bwd_pallas, first pallas_call)
//   flash_dq_kernel    <- _dq_kernel    (_bwd_pallas, second pallas_call)
// for f32 inputs; bf16 inputs go to the wgmma kernels of flash_fwd_sm90.cu
// (forward) and flash_bwd_sm90.cu (dK/dV, dQ), and only delta serves both
// dtypes here. Same contract, with the layout the model's projections
// produce: q, O, dO are [B, Sq, H, D], k, v, dK, dV are [B, Sk, H, D], all
// contiguous, in one dtype; LSE and delta are [B, H, Sq] f32. Causality is
// end-aligned (offset = Sk - Sq >= 0): query row i sees keys <= i + offset.
// Scores and every accumulator are f32.
//
// What bounds them on the H100: operations for the forward (4*D flops per
// (row, key) pair the rows see), dK/dV (8*D) and dQ (6*D), against a few
// bytes per pair; delta, a row reduction of O * dO, is bound by the bytes
// of O and dO (one warp per (token, head) with 16-byte loads). The f32
// products run an exact f32 emulation of mma.sync m16n8k16 (warp shuffles
// and FMAs; mma_sm80.cuh): slow, and only for tests and f32 callers; tiles
// are staged once in shared memory and reused by every warp of the block,
// and causal tiles above the diagonal are skipped.
//
// Design. The Pallas grids run their last axis in order on one core and
// carry accumulators in VMEM across it; CUDA blocks share nothing, so
// that axis is a loop inside each block:
// - forward: one block (4 warps) per (q tile of 64 rows, head, batch);
//   each warp owns 16 rows, loops over the 64-key tiles up to the last one
//   its tile's last row can see, keeps m, l and O in registers;
// - dK/dV: one block (8 warps) per (k tile of 32 keys, head, batch),
//   looping over 64-row q tiles from the first that sees the k tile; each
//   pass recomputes S^T and P^T from the LSE and dP^T = V dO^T, writes P^T
//   and dS^T to shared memory, then every warp accumulates its slice of
//   dV += P^T dO and dK += dS^T Q in registers; written once, no atomics;
// - dQ: one block (8 warps) per (q tile of 64 rows, head, batch), looping
//   over 32-key tiles up to the diagonal; dS goes through shared memory
//   and dQ += dS K accumulates in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm80.cuh"

namespace {

constexpr float kNegInf = -1e30f;   // the TPU kernel's finite mask value
constexpr int kPad = 8;             // elements of padding per staged row

// Stage rows [0, rows) of a [*, D] slab (global row stride `stride`
// elements) into shared memory with row stride ld; rows at or past
// `valid` and columns D..Dp-1 are zero. 16-byte copies.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src, size_t stride,
                                      int rows, int valid, int D, int Dp,
                                      int tid, int nthreads) {
  constexpr int kVec = 16 / sizeof(T);
  const int vpr = Dp / kVec;
  for (int i = tid; i < rows * vpr; i += nthreads) {
    const int r = i / vpr, c = (i % vpr) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid && c < D)
      val = *reinterpret_cast<const uint4*>(src + (size_t)r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

struct Shape {
  int Sq, Sk, H, D, Dp, causal;
  float scale;
};

// --------------------------------------------------------------- forward
constexpr int kFwdBQ = 64, kFwdBK = 64, kFwdWarps = 4;

template <typename T, int DMAX>
__global__ void __launch_bounds__(32 * kFwdWarps)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Shape sh) {
  using M = Mma<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = sh.Dp + kPad;
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + kFwdBQ * ld;
  T* vs = ks + kFwdBK * ld;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kFwdBQ;
  const int offset = sh.Sk - sh.Sq;
  const size_t row_stride = (size_t)sh.H * sh.D;
  const T* qb = q + ((size_t)b * sh.Sq * sh.H + h) * sh.D;
  const T* kb = k + ((size_t)b * sh.Sk * sh.H + h) * sh.D;
  const T* vb = v + ((size_t)b * sh.Sk * sh.H + h) * sh.D;

  stage(qs, ld, qb + (size_t)q0 * row_stride, row_stride, kFwdBQ,
        sh.Sq - q0, sh.D, sh.Dp, tid, blockDim.x);

  const int last_row = min(q0 + kFwdBQ, sh.Sq) - 1;
  int n_kt = (sh.Sk + kFwdBK - 1) / kFwdBK;
  if (sh.causal) n_kt = min(n_kt, (last_row + offset) / kFwdBK + 1);

  float acc[DMAX / 8][4];
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int row_base = q0 + warp * 16 + g;   // rows row_base, row_base + 8

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kFwdBK;
    __syncthreads();   // every warp is done with the previous K/V tile
    stage(ks, ld, kb + (size_t)k0 * row_stride, row_stride, kFwdBK,
          sh.Sk - k0, sh.D, sh.Dp, tid, blockDim.x);
    stage(vs, ld, vb + (size_t)k0 * row_stride, row_stride, kFwdBK,
          sh.Sk - k0, sh.D, sh.Dp, tid, blockDim.x);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the 64 keys
    float s[kFwdBK / 8][4];
#pragma unroll
    for (int j = 0; j < kFwdBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      if (kk * 16 >= sh.Dp) break;
      typename M::A a;
      M::load_a(a, qs + warp * 16 * ld + kk * 16, ld, lane);
#pragma unroll
      for (int j = 0; j < kFwdBK / 8; ++j) {
        typename M::B bb;
        M::load_b_nk(bb, ks + j * 8 * ld + kk * 16, ld, lane);
        M::mma(s[j], a, bb, lane);
      }
    }

    // scale, mask, online softmax (rows g: e = 0, 1; rows g + 8: e = 2, 3)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kFwdBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_base + (e >> 1) * 8;
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const bool ok = col < sh.Sk && (!sh.causal || col <= row + offset);
        s[j][e] = ok ? s[j][e] * sh.scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float m_new = fmaxf(m[hr], quad_max(mx[hr]));
      alpha[hr] = expf(m[hr] - m_new);
      m[hr] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kFwdBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) l[hr] = alpha[hr] * l[hr] + quad_sum(rs[hr]);
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n) {
      acc[n][0] *= alpha[0]; acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1]; acc[n][3] *= alpha[1];
    }

    // O += P V, with P rounded to the input dtype
#pragma unroll
    for (int kk = 0; kk < kFwdBK / 16; ++kk) {
      typename M::A a;
      M::a_from_c(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < DMAX / 8; ++n) {
        if (n * 8 >= sh.D) break;
        typename M::B bb;
        M::load_b_kn(bb, vs + kk * 16 * ld + n * 8, ld, lane);
        M::mma(acc[n], a, bb, lane);
      }
    }
  }

  // epilogue: O = acc / l (l == 0 guarded), LSE = m + log(l)
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row_base + hr * 8;
    if (row >= sh.Sq) continue;
    const float lv = l[hr] == 0.f ? 1.f : l[hr];
    const float inv = 1.f / lv;
    T* orow = o + (((size_t)b * sh.Sq + row) * sh.H + h) * sh.D;
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n) {
      if (n * 8 >= sh.D) break;
      store2(orow + n * 8 + 2 * t, acc[n][2 * hr] * inv, acc[n][2 * hr + 1] * inv);
    }
    if (t == 0) lse[((size_t)b * sh.H + h) * sh.Sq + row] = m[hr] + logf(lv);
  }
}

// ----------------------------------------------------------------- delta
constexpr int kDeltaWarps = 8;

template <typename T>
__global__ void __launch_bounds__(32 * kDeltaWarps)
flash_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                   float* __restrict__ delta, int B, int S, int H, int D) {
  const int lane = threadIdx.x & 31;
  const size_t vec = (size_t)blockIdx.x * kDeltaWarps + (threadIdx.x >> 5);
  if (vec >= (size_t)B * S * H) return;
  const T* op = o + vec * D;
  const T* dp = dout + vec * D;
  constexpr int kVec = 16 / sizeof(T);
  float sum = 0.f;
  for (int c = lane * kVec; c < D; c += 32 * kVec) {
    const uint4 a = *reinterpret_cast<const uint4*>(op + c);
    const uint4 d = *reinterpret_cast<const uint4*>(dp + c);
    const T* ae = reinterpret_cast<const T*>(&a);
    const T* de = reinterpret_cast<const T*>(&d);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      float x, y;
      if constexpr (sizeof(T) == 2) {
        x = __bfloat162float(ae[i]);
        y = __bfloat162float(de[i]);
      } else {
        x = ae[i];
        y = de[i];
      }
      sum = fmaf(x, y, sum);
    }
  }
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) sum += __shfl_xor_sync(kFull, sum, w);
  if (lane == 0) {
    const int hh = vec % H;
    const size_t bs = vec / H;             // b * S + s
    const int s = bs % S;
    const int b = bs / S;
    delta[((size_t)b * H + hh) * S + s] = sum;
  }
}

// ----------------------------------------------------------------- dK/dV
constexpr int kBwdBK = 32, kBwdBQ = 64, kBwdWarps = 8;
constexpr int kPLd = kBwdBQ + kPad;   // row stride of the staged P^T / dS^T

template <typename T, int DMAX>
__global__ void __launch_bounds__(32 * kBwdWarps)
flash_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  T* __restrict__ dk, T* __restrict__ dv, Shape sh) {
  using M = Mma<T>;
  constexpr int NT = DMAX / 32;   // output n-tiles (8 columns) per warp
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = sh.Dp + kPad;
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + kBwdBK * ld;
  T* qs = vs + kBwdBK * ld;
  T* dos = qs + kBwdBQ * ld;
  T* ps = dos + kBwdBQ * ld;            // P^T  [kBwdBK][kPLd]
  T* dss = ps + kBwdBK * kPLd;          // dS^T [kBwdBK][kPLd]
  float* lse_s = reinterpret_cast<float*>(dss + kBwdBK * kPLd);
  float* delta_s = lse_s + kBwdBQ;

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = kt * kBwdBK;
  const int offset = sh.Sk - sh.Sq;
  const size_t row_stride = (size_t)sh.H * sh.D;
  const T* qb = q + ((size_t)b * sh.Sq * sh.H + h) * sh.D;
  const T* dob = dout + ((size_t)b * sh.Sq * sh.H + h) * sh.D;
  const float* lseb = lse + ((size_t)b * sh.H + h) * sh.Sq;
  const float* deltab = delta + ((size_t)b * sh.H + h) * sh.Sq;

  stage(ks, ld, k + ((size_t)(b * sh.Sk + k0) * sh.H + h) * sh.D, row_stride,
        kBwdBK, sh.Sk - k0, sh.D, sh.Dp, tid, blockDim.x);
  stage(vs, ld, v + ((size_t)(b * sh.Sk + k0) * sh.H + h) * sh.D, row_stride,
        kBwdBK, sh.Sk - k0, sh.D, sh.Dp, tid, blockDim.x);

  // phase 1 tiles: key rows rg*16.., q columns qc0.. (two n-tiles)
  const int rg = warp & 1;
  const int qc0 = (warp >> 1) * 16;
  // phase 2 tiles: key rows rg*16.., output columns (warp >> 1) * NT * 8..
  const int nt0 = (warp >> 1) * NT;

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

  const int first_q = sh.causal ? max(0, k0 - offset) / kBwdBQ : 0;
  const int n_qt = (sh.Sq + kBwdBQ - 1) / kBwdBQ;
  for (int qt = first_q; qt < n_qt; ++qt) {
    const int q0 = qt * kBwdBQ;
    __syncthreads();   // the previous pass is done with Q, dO, P^T, dS^T
    stage(qs, ld, qb + (size_t)q0 * row_stride, row_stride, kBwdBQ,
          sh.Sq - q0, sh.D, sh.Dp, tid, blockDim.x);
    stage(dos, ld, dob + (size_t)q0 * row_stride, row_stride, kBwdBQ,
          sh.Sq - q0, sh.D, sh.Dp, tid, blockDim.x);
    for (int i = tid; i < kBwdBQ; i += blockDim.x) {
      const bool in = q0 + i < sh.Sq;
      lse_s[i] = in ? lseb[q0 + i] : 0.f;
      delta_s[i] = in ? deltab[q0 + i] : 0.f;
    }
    __syncthreads();

    // phase 1: S^T = K Q^T and dP^T = V dO^T on this warp's 16 x 16 tile
    float st[2][4], dpt[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      if (kk * 16 >= sh.Dp) break;
      typename M::A ak, av;
      M::load_a(ak, ks + rg * 16 * ld + kk * 16, ld, lane);
      M::load_a(av, vs + rg * 16 * ld + kk * 16, ld, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        typename M::B bq, bo;
        M::load_b_nk(bq, qs + (qc0 + j * 8) * ld + kk * 16, ld, lane);
        M::load_b_nk(bo, dos + (qc0 + j * 8) * ld + kk * 16, ld, lane);
        M::mma(st[j], ak, bq, lane);
        M::mma(dpt[j], av, bo, lane);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kr = rg * 16 + g + (e >> 1) * 8;       // key row in tile
        const int qc = qc0 + j * 8 + 2 * t + (e & 1);    // q column in tile
        const int key = k0 + kr, row = q0 + qc;
        const bool ok = key < sh.Sk && row < sh.Sq &&
                        (!sh.causal || key <= row + offset);
        const float p = ok ? expf(st[j][e] * sh.scale - lse_s[qc]) : 0.f;
        const float ds = p * (dpt[j][e] - delta_s[qc]) * sh.scale;
        ps[kr * kPLd + qc] = to_t<T>(p);
        dss[kr * kPLd + qc] = to_t<T>(ds);
      }
    }
    __syncthreads();

    // phase 2: dV += P^T dO, dK += dS^T Q on this warp's output columns
#pragma unroll
    for (int kk = 0; kk < kBwdBQ / 16; ++kk) {
      typename M::A ap, as;
      M::load_a(ap, ps + rg * 16 * kPLd + kk * 16, kPLd, lane);
      M::load_a(as, dss + rg * 16 * kPLd + kk * 16, kPLd, lane);
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const int nt = nt0 + i;
        if (nt * 8 >= sh.D) break;
        typename M::B bo, bq;
        M::load_b_kn(bo, dos + kk * 16 * ld + nt * 8, ld, lane);
        M::load_b_kn(bq, qs + kk * 16 * ld + nt * 8, ld, lane);
        M::mma(dva[i], ap, bo, lane);
        M::mma(dka[i], as, bq, lane);
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = k0 + rg * 16 + g + hr * 8;
    if (key >= sh.Sk) continue;
    const size_t off = (((size_t)b * sh.Sk + key) * sh.H + h) * sh.D;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int nt = nt0 + i;
      if (nt * 8 >= sh.D) break;
      store2(dk + off + nt * 8 + 2 * t, dka[i][2 * hr], dka[i][2 * hr + 1]);
      store2(dv + off + nt * 8 + 2 * t, dva[i][2 * hr], dva[i][2 * hr + 1]);
    }
  }
}

// -------------------------------------------------------------------- dQ
constexpr int kDqBQ = 64, kDqBK = 32, kDqWarps = 8;
constexpr int kSLd = kDqBK + kPad;    // row stride of the staged dS

template <typename T, int DMAX>
__global__ void __launch_bounds__(32 * kDqWarps)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, Shape sh) {
  using M = Mma<T>;
  constexpr int NT = DMAX / 16;   // output n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = sh.Dp + kPad;
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + kDqBQ * ld;
  T* ks = dos + kDqBQ * ld;
  T* vs = ks + kDqBK * ld;
  T* dss = vs + kDqBK * ld;             // dS [kDqBQ][kSLd]
  float* lse_s = reinterpret_cast<float*>(dss + kDqBQ * kSLd);
  float* delta_s = lse_s + kDqBQ;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kDqBQ;
  const int offset = sh.Sk - sh.Sq;
  const size_t row_stride = (size_t)sh.H * sh.D;
  const T* kb = k + ((size_t)b * sh.Sk * sh.H + h) * sh.D;
  const T* vb = v + ((size_t)b * sh.Sk * sh.H + h) * sh.D;

  stage(qs, ld, q + ((size_t)(b * sh.Sq + q0) * sh.H + h) * sh.D, row_stride,
        kDqBQ, sh.Sq - q0, sh.D, sh.Dp, tid, blockDim.x);
  stage(dos, ld, dout + ((size_t)(b * sh.Sq + q0) * sh.H + h) * sh.D, row_stride,
        kDqBQ, sh.Sq - q0, sh.D, sh.Dp, tid, blockDim.x);
  for (int i = tid; i < kDqBQ; i += blockDim.x) {
    const bool in = q0 + i < sh.Sq;
    const size_t idx = ((size_t)b * sh.H + h) * sh.Sq + q0 + i;
    lse_s[i] = in ? lse[idx] : 0.f;
    delta_s[i] = in ? delta[idx] : 0.f;
  }

  const int rg = warp & 3;                 // rows rg*16.. in both phases
  const int kc0 = (warp >> 2) * 16;        // phase 1: key columns kc0..
  const int nt0 = (warp >> 2) * NT;        // phase 2: output n-tiles

  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int last_row = min(q0 + kDqBQ, sh.Sq) - 1;
  int n_kt = (sh.Sk + kDqBK - 1) / kDqBK;
  if (sh.causal) n_kt = min(n_kt, (last_row + offset) / kDqBK + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kDqBK;
    __syncthreads();   // the previous pass is done with K, V, dS
    stage(ks, ld, kb + (size_t)k0 * row_stride, row_stride, kDqBK,
          sh.Sk - k0, sh.D, sh.Dp, tid, blockDim.x);
    stage(vs, ld, vb + (size_t)k0 * row_stride, row_stride, kDqBK,
          sh.Sk - k0, sh.D, sh.Dp, tid, blockDim.x);
    __syncthreads();

    // phase 1: S = Q K^T and dP = dO V^T on this warp's 16 x 16 tile
    float s[2][4], dp[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      if (kk * 16 >= sh.Dp) break;
      typename M::A aq, ao;
      M::load_a(aq, qs + rg * 16 * ld + kk * 16, ld, lane);
      M::load_a(ao, dos + rg * 16 * ld + kk * 16, ld, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        typename M::B bk, bv;
        M::load_b_nk(bk, ks + (kc0 + j * 8) * ld + kk * 16, ld, lane);
        M::load_b_nk(bv, vs + (kc0 + j * 8) * ld + kk * 16, ld, lane);
        M::mma(s[j], aq, bk, lane);
        M::mma(dp[j], ao, bv, lane);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qr = rg * 16 + g + (e >> 1) * 8;
        const int kc = kc0 + j * 8 + 2 * t + (e & 1);
        const int row = q0 + qr, key = k0 + kc;
        const bool ok = key < sh.Sk && row < sh.Sq &&
                        (!sh.causal || key <= row + offset);
        const float p = ok ? expf(s[j][e] * sh.scale - lse_s[qr]) : 0.f;
        dss[qr * kSLd + kc] = to_t<T>(p * (dp[j][e] - delta_s[qr]) * sh.scale);
      }
    }
    __syncthreads();

    // phase 2: dQ += dS K
#pragma unroll
    for (int kk = 0; kk < kDqBK / 16; ++kk) {
      typename M::A as;
      M::load_a(as, dss + rg * 16 * kSLd + kk * 16, kSLd, lane);
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const int nt = nt0 + i;
        if (nt * 8 >= sh.D) break;
        typename M::B bk;
        M::load_b_kn(bk, ks + kk * 16 * ld + nt * 8, ld, lane);
        M::mma(acc[i], as, bk, lane);
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + rg * 16 + g + hr * 8;
    if (row >= sh.Sq) continue;
    T* dqrow = dq + (((size_t)b * sh.Sq + row) * sh.H + h) * sh.D;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int nt = nt0 + i;
      if (nt * 8 >= sh.D) break;
      store2(dqrow + nt * 8 + 2 * t, acc[i][2 * hr], acc[i][2 * hr + 1]);
    }
  }
}

// ---------------------------------------------------------------- launch
// Raise a kernel's dynamic shared memory cap past 48 KB; `done` is the
// largest cap already set for that kernel (one static per instantiation).
template <typename K>
int allow_smem(K kernel, size_t bytes, size_t& done) {
  if (bytes <= 48 * 1024 || bytes <= done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) done = bytes;
  return (int)e;
}

Shape make_shape(int Sq, int Sk, int H, int D, float scale, int causal) {
  return Shape{Sq, Sk, H, D, (D + 15) / 16 * 16, causal, scale};
}

template <typename T, int DMAX>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
               int B, const Shape& sh, cudaStream_t stream) {
  const int ld = sh.Dp + kPad;
  const size_t smem = sizeof(T) * (size_t)(kFwdBQ + 2 * kFwdBK) * ld;
  auto kern = flash_fwd_kernel<T, DMAX>;
  static size_t smem_set = 0;
  const int err = allow_smem(kern, smem, smem_set);
  if (err) return err;
  const dim3 grid((sh.Sq + kFwdBQ - 1) / kFwdBQ, sh.H, B);
  kern<<<grid, 32 * kFwdWarps, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, sh);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_delta(const void* o, const void* dout, float* delta, int B, int S,
                 int H, int D, cudaStream_t stream) {
  const size_t vecs = (size_t)B * S * H;
  const unsigned blocks = (unsigned)((vecs + kDeltaWarps - 1) / kDeltaWarps);
  flash_delta_kernel<T><<<blocks, 32 * kDeltaWarps, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, B, S, H, D);
  return (int)cudaGetLastError();
}

template <typename T, int DMAX>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dk, void* dv, int B,
                const Shape& sh, cudaStream_t stream) {
  const int ld = sh.Dp + kPad;
  const size_t smem = sizeof(T) * ((size_t)(2 * kBwdBK + 2 * kBwdBQ) * ld +
                                   2 * kBwdBK * kPLd) +
                      sizeof(float) * 2 * kBwdBQ;
  auto kern = flash_dkdv_kernel<T, DMAX>;
  static size_t smem_set = 0;
  const int err = allow_smem(kern, smem, smem_set);
  if (err) return err;
  const dim3 grid((sh.Sk + kBwdBK - 1) / kBwdBK, sh.H, B);
  kern<<<grid, 32 * kBwdWarps, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), sh);
  return (int)cudaGetLastError();
}

template <typename T, int DMAX>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B,
              const Shape& sh, cudaStream_t stream) {
  const int ld = sh.Dp + kPad;
  const size_t smem = sizeof(T) * ((size_t)(2 * kDqBQ + 2 * kDqBK) * ld +
                                   kDqBQ * kSLd) +
                      sizeof(float) * 2 * kDqBQ;
  auto kern = flash_dq_kernel<T, DMAX>;
  static size_t smem_set = 0;
  const int err = allow_smem(kern, smem, smem_set);
  if (err) return err;
  const dim3 grid((sh.Sq + kDqBQ - 1) / kDqBQ, sh.H, B);
  kern<<<grid, 32 * kDqWarps, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), sh);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). dtype: 0 = float32,
// 1 = bfloat16. Each returns the cudaError_t of its launch (0 = success).
// The caller has checked: D % 8 == 0, D <= 256, Sk >= Sq when causal, all
// tensors contiguous, on one device and 16-byte aligned. The forward, dK/dV
// and dQ take f32 only (bf16: flash_fwd_sm90.cu, flash_bwd_sm90.cu), so each
// dtype has exactly one kernel of each; delta takes both.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         float* lse, int B, int Sq, int Sk, int H, int D,
                         float scale, int causal, int dtype, void* stream) {
  const Shape sh = make_shape(Sq, Sk, H, D, scale, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  if (D <= 128) return launch_fwd<float, 128>(q, k, v, o, lse, B, sh, s);
  return launch_fwd<float, 256>(q, k, v, o, lse, B, sh, s);
}

extern "C" int flash_delta(const void* o, const void* dout, float* delta, int B,
                           int S, int H, int D, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_delta<__nv_bfloat16>(o, dout, delta, B, S, H, D, s);
  if (dtype == 0) return launch_delta<float>(o, dout, delta, B, S, H, D, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_dkdv(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse, const float* delta,
                          void* dk, void* dv, int B, int Sq, int Sk, int H, int D,
                          float scale, int causal, int dtype, void* stream) {
  const Shape sh = make_shape(Sq, Sk, H, D, scale, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  if (D <= 128)
    return launch_dkdv<float, 128>(q, k, v, dout, lse, delta, dk, dv, B, sh, s);
  return launch_dkdv<float, 256>(q, k, v, dout, lse, delta, dk, dv, B, sh, s);
}

extern "C" int flash_dq(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, const float* delta,
                        void* dq, int B, int Sq, int Sk, int H, int D, float scale,
                        int causal, int dtype, void* stream) {
  const Shape sh = make_shape(Sq, Sk, H, D, scale, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  if (D <= 128) return launch_dq<float, 128>(q, k, v, dout, lse, delta, dq, B, sh, s);
  return launch_dq<float, 256>(q, k, v, dout, lse, delta, dq, B, sh, s);
}
