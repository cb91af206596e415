// Paged attention of new-token queries against a paged KV pool, for
// Hopper (sm_90a).
//
// Replaces ray_tpu/ops/paged_flash.py::_paged_kernel (the Pallas TPU
// kernel behind paged_flash_attention). Same contract: q [B, C, H, D] at
// absolute positions q_positions [B, C]; one layer's pool k/v
// [N, bs, KVH, D]; block_tables [B, T]; lens [B] live tokens per
// sequence; out [B, C, H, D] in q's dtype. A row attends every key whose
// position is <= its own; only pages below max(ceil(lens/bs), 1) are
// read. Scores, the running max m, the denominator l and the accumulator
// are f32; p is rounded to the cache dtype before P.V, as on the TPU.
//
// What bounds it: bytes at decode (every live K/V row is read once per
// (sequence, kv head) for one to four query rows: ~2 flops per byte, far
// below the ~295 flop/B where the tensor cores become the limit), the
// tensor cores at chunked prefill (a staged key row serves up to 64 query
// rows). The design:
// - keys, not pages, are staged: a block walks tiles of 64 keys; each key
//   row is one contiguous D-vector at block_tables[b, j / bs], slot
//   j % bs, kv head g, copied with 16-byte cp.async.cg into a ring of
//   shared-memory stages (two where two blocks still fit an SM, else one
//   stage in each of two blocks), so loads overlap products. Any block size works; keys past
//   the live range are zero-filled. The block-table entries of the
//   block's keys are read into shared memory once;
// - both products run on the tensor cores with mma.sync m16n8k16
//   (mma_sm80.cuh; the exact f32 emulation for f32 inputs): the rows of a
//   block are tokens x GQA group (row r of kv head g is token r / rep,
//   head g * rep + r % rep; the cache is never repeated), in warp tiles
//   of 16 rows, padded. V fragments come from ldmatrix.trans;
// - split-K over keys: the grid is (splits, KVH, B x row tiles) and each
//   split covers a fixed number of keys (256), so a long sequence spreads
//   over several blocks while a short one takes one; a split past its
//   sequence's live keys (or past every key its rows may see) exits at
//   once. Inside a block the 4 warps are WR row tiles x (4 / WR) key
//   slices of each tile: at decode (WR = 1) every warp takes its own 16
//   keys of the tile, at prefill (WR = 4) every warp its own 16 rows;
//   every warp copies. The key slices merge their (m, l, O) through
//   shared memory at the end;
// - with more than one split, each split writes f32 partials (O / l and
//   lse = m + log l, -inf where a row saw no key) and a second kernel,
//   launched from the same entry, merges them; with one split the block
//   writes the output itself.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm80.cuh"

namespace paged {

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* block_tables;
  const int* q_positions;
  const int* lens;
  void* out;
  float* part_o;     // [n_splits, B, KVH, rows, D] (n_splits > 1)
  float* part_lse;   // [n_splits, B, KVH, rows]
  int* part_n;       // [B, KVH, n_rt]: live splits of each row tile
  int B, C, H, KVH, D, bs, T, N;
  int n_rt, n_splits, split_keys;
  float sm_scale;
};

// The launchers of the instantiations (dtype x largest head dim x row
// tiles a block). The build compiles this source as seven translation
// units, the bf16 D <= 128 set in one and each D <= 256 instantiation in
// one of its own (PAGED_PART = 0-6; ray_tpu_torch/_build.py PARTS), so
// that nvcc compiles them in parallel.
#ifndef PAGED_PART
#error "paged_attention.cu is built in parts: define PAGED_PART (0-6)"
#endif
int launch_bf16_d128(const Args& a, int wr, cudaStream_t stream);
template <typename T, int WR>
int launch_d256(const Args& a, cudaStream_t stream);
template <> int launch_d256<__nv_bfloat16, 1>(const Args& a, cudaStream_t stream);
template <> int launch_d256<__nv_bfloat16, 2>(const Args& a, cudaStream_t stream);
template <> int launch_d256<__nv_bfloat16, 4>(const Args& a, cudaStream_t stream);
template <> int launch_d256<float, 1>(const Args& a, cudaStream_t stream);
template <> int launch_d256<float, 2>(const Args& a, cudaStream_t stream);
template <> int launch_d256<float, 4>(const Args& a, cudaStream_t stream);

}  // namespace paged

namespace {

using paged::Args;

constexpr int kBK = 64;             // keys per staged tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSplitKeys = 256;  // largest split the block-table cache holds

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(fill ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
__device__ __forceinline__ void store4(T* p, float a, float b, float c, float d);
template <>
__device__ __forceinline__ void store4<float>(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p, float a, float b,
                                                      float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// Shared memory of one block: the query tile [TR][ld] then NS stages of
// K [kBK][ld] and V [kBK][ld]; ld pads each row by 16 bytes past the head
// dim rounded up to 16 (rows start 16-byte aligned, banks spread).
template <typename T>
__host__ __device__ constexpr int row_ld(int D) {
  return (D + 15) / 16 * 16 + 16 / (int)sizeof(T);
}
template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int TR, int D, int NS) {
  return sizeof(T) * (size_t)row_ld<T>(D) * (TR + NS * 2 * kBK);
}
// Ring depth: two stages where two blocks still fit on an SM (so one
// block's loads overlap its own products and the other block's), else
// one (bf16 at D = 256: two blocks of one stage each, whose loads and
// products interleave, rather than one block of two stages).
template <typename T, int DMAX, int WR>
__host__ __device__ constexpr int stages() {
  return smem_bytes<T>(16 * WR, DMAX, 2) <= 110 * 1024 ? 2 : 1;
}

// One block: row tile rt of (sequence b, kv head g), keys of split sp.
template <typename T, int DMAX, int WR>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(Args a) {
  using M = Mma<T>;
  constexpr int NS = stages<T, DMAX, WR>();
  constexpr int WK = kWarps / WR;   // key slices per tile
  constexpr int TR = 16 * WR;       // rows per block
  constexpr int KPW = kBK / WK;     // keys per warp per tile: 16, 32 or 64
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int pos_s[TR];
  __shared__ int page_s[kMaxSplitKeys + 1];
  __shared__ float ml_s[WK * TR][2];
  __shared__ int lens_s;

  const int D = a.D, Dp = (D + 15) / 16 * 16, ld = row_ld<T>(D);
  T* q_s = reinterpret_cast<T*>(smem);
  T* kv_s = q_s + TR * ld;
  const int sp = blockIdx.x, g = blockIdx.y;
  const int b = blockIdx.z / a.n_rt, rt = blockIdx.z % a.n_rt;
  const int rep = a.H / a.KVH, rows = a.C * rep;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k_lo = sp * a.split_keys;
  const int p_lo = k_lo / a.bs;

  // one round trip for what the block needs to know: the rows'
  // positions, the sequence's length, the table entries of the split
  for (int r = tid; r < TR; r += kThreads) {
    const int row = rt * TR + r;
    pos_s[r] = row < rows ? a.q_positions[b * a.C + row / rep] : -1;
  }
  if (tid == kThreads - 1) lens_s = a.lens[b];
  for (int i = tid; (p_lo + i) * a.bs < k_lo + a.split_keys && p_lo + i < a.T &&
                    i <= kMaxSplitKeys;
       i += kThreads)
    page_s[i] = min(max(a.block_tables[b * a.T + p_lo + i], 0), a.N - 1);
  __syncthreads();
  int max_pos = -1;
  for (int r = 0; r < TR; ++r) max_pos = max(max_pos, pos_s[r]);
  // keys [0, key_end) are live and seen by some row of the block
  const int n_pages = min(max((lens_s + a.bs - 1) / a.bs, 1), a.T);
  const int key_end = min(n_pages * a.bs, max_pos + 1);
  const int n_live = max((key_end + a.split_keys - 1) / a.split_keys, 1);
  if (sp == 0 && tid == 0 && a.n_splits > 1)
    a.part_n[((size_t)b * a.KVH + g) * a.n_rt + rt] = n_live;
  if (sp >= n_live) return;
  const int k_hi = min(k_lo + a.split_keys, key_end);
  const int n_tiles = max((k_hi - k_lo + kBK - 1) / kBK, 0);

  // K columns D..Dp-1 of every stage are zero (cp.async never writes them)
  for (int i = tid; i < NS * kBK * (Dp - D) / kVec; i += kThreads) {
    const int per = (Dp - D) / kVec;
    const int r = i / per, c = D + (i % per) * kVec;
    const int st = r / kBK, kr = r % kBK;
    *reinterpret_cast<uint4*>(kv_s + ((size_t)st * 2 * kBK + kr) * ld + c) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  // the query tile rides in the first tile's copy group: zero past the
  // rows and in columns D..Dp-1
  const T* q = static_cast<const T*>(a.q);
  const int units = Dp / kVec;
  for (int i = tid; i < TR * units; i += kThreads) {
    const int r = i / units, c = (i % units) * kVec;
    const int row = rt * TR + r;
    const bool live = row < rows && c < D;
    size_t src = 0;
    if (live) src = ((size_t)(b * a.C + row / rep) * a.H + g * rep + row % rep) * D + c;
    cp_async16(q_s + r * ld + c, q + src, live);
  }

  const T* kc = static_cast<const T*>(a.k);
  const T* vc = static_cast<const T*>(a.v);
  const int dunits = D / kVec;
  auto issue = [&](int tile, int st) {
    T* ks = kv_s + (size_t)st * 2 * kBK * ld;
    T* vs = ks + kBK * ld;
    const int j0 = k_lo + tile * kBK;
    for (int x = tid; x < kBK * dunits; x += kThreads) {
      const int kr = x / dunits, c = (x % dunits) * kVec;
      const int j = j0 + kr;
      const bool live = j < k_hi;
      size_t src = 0;
      if (live) {
        const int page = page_s[j / a.bs - p_lo];
        src = (((size_t)page * a.bs + j % a.bs) * a.KVH + g) * D + c;
      }
      cp_async16(ks + kr * ld + c, kc + src, live);
      cp_async16(vs + kr * ld + c, vc + src, live);
    }
  };

  const int wr = warp % WR, wk = warp / WR;
  const int gq = lane >> 2, tq = lane & 3;
  const int pos0 = pos_s[16 * wr + gq], pos1 = pos_s[16 * wr + gq + 8];
  int warp_pos = -1;
  for (int r = 0; r < 16; ++r) warp_pos = max(warp_pos, pos_s[16 * wr + r]);
  float acc[DMAX / 8][4];
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n_tiles) issue(s, s);
    cp_async_commit();
  }
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + NS - 1 < n_tiles) issue(tile + NS - 1, (tile + NS - 1) % NS);
    cp_async_commit();
    cp_async_wait<NS - 1>();
    __syncthreads();
    const T* ks = kv_s + (size_t)(tile % NS) * 2 * kBK * ld + wk * KPW * ld;
    const T* vs = ks + kBK * ld;
    const int key0 = k_lo + tile * kBK + wk * KPW;   // this warp's first key
    if (key0 < k_hi && key0 <= warp_pos) {
      // S = Q K^T on this warp's 16 rows and KPW keys
      float s[KPW / 8][4];
#pragma unroll
      for (int j = 0; j < KPW / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DMAX / 16; ++kk) {
        if (kk * 16 >= Dp) break;
        typename M::A qa;
        M::load_a(qa, q_s + 16 * wr * ld + kk * 16, ld, lane);
#pragma unroll
        for (int j = 0; j < KPW / 8; ++j) {
          typename M::B kb;
          M::load_b_nk(kb, ks + 8 * j * ld + kk * 16, ld, lane);
          M::mma(s[j], qa, kb, lane);
        }
      }
      // mask (key < k_hi, key <= the row's position), online softmax
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < KPW / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + 8 * j + 2 * tq + (e & 1);
          const bool ok = key < k_hi && key <= ((e >> 1) ? pos1 : pos0);
          s[j][e] = ok ? s[j][e] * a.sm_scale : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      }
      float alpha[2], m_use[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float m_new = fmaxf(m[hr], quad_max(mx[hr]));
        m_use[hr] = m_new == -INFINITY ? 0.f : m_new;   // no key seen yet
        alpha[hr] = expf(m[hr] - m_use[hr]);
        m[hr] = m_new;
      }
#pragma unroll
      for (int j = 0; j < KPW / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - m_use[e >> 1]);
          rs[e >> 1] += s[j][e];
        }
      }
      l[0] = alpha[0] * l[0] + rs[0];   // per-thread partial sums
      l[1] = alpha[1] * l[1] + rs[1];
#pragma unroll
      for (int n = 0; n < DMAX / 8; ++n) {
        acc[n][0] *= alpha[0]; acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1]; acc[n][3] *= alpha[1];
      }
      // O += P V, P rounded to the cache dtype in the A fragment
#pragma unroll
      for (int kk = 0; kk < KPW / 16; ++kk) {
        typename M::A pa;
        M::a_from_c(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < DMAX / 8; n += 2) {
          if (n * 8 >= D) break;
          typename M::B b0, b1;
          if ((n + 1) * 8 < D) {
            M::load_b_kn_x2(b0, b1, vs + 16 * kk * ld + n * 8, ld, lane);
            M::mma(acc[n], pa, b0, lane);
            M::mma(acc[n + 1], pa, b1, lane);
          } else {
            M::load_b_kn(b0, vs + 16 * kk * ld + n * 8, ld, lane);
            M::mma(acc[n], pa, b0, lane);
          }
        }
      }
    }
    __syncthreads();   // every warp is done with this stage
  }
  cp_async_wait<0>();

  // merge the key slices: each warp's (m, l, acc) through shared memory
  float* red = reinterpret_cast<float*>(kv_s);   // [WK][TR][D] f32
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = 16 * wr + gq + 8 * hr;
    const float lsum = quad_sum(l[hr]);
    if (tq == 0) {
      ml_s[wk * TR + r][0] = m[hr];
      ml_s[wk * TR + r][1] = lsum;
    }
    float* dst = red + ((size_t)wk * TR + r) * D;
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n) {
      if (n * 8 >= D) break;
      *reinterpret_cast<float2*>(dst + 8 * n + 2 * tq) =
          make_float2(acc[n][2 * hr], acc[n][2 * hr + 1]);
    }
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out);
  const int d4 = D / 4;
  for (int x = tid; x < TR * d4; x += kThreads) {
    const int r = x / d4, c = (x % d4) * 4;
    const int row = rt * TR + r;
    if (row >= rows) continue;
    float mmax = -INFINITY;
#pragma unroll
    for (int w = 0; w < WK; ++w) mmax = fmaxf(mmax, ml_s[w * TR + r][0]);
    float lsum = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    if (mmax != -INFINITY) {
#pragma unroll
      for (int w = 0; w < WK; ++w) {
        const float mw = ml_s[w * TR + r][0];
        if (mw == -INFINITY) continue;
        const float f = expf(mw - mmax);
        lsum += f * ml_s[w * TR + r][1];
        const float4 v = *reinterpret_cast<const float4*>(red + ((size_t)w * TR + r) * D + c);
        o.x += f * v.x; o.y += f * v.y; o.z += f * v.z; o.w += f * v.w;
      }
    }
    const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
    const int head = g * rep + row % rep;
    if (a.n_splits == 1) {
      store4(out + ((size_t)(b * a.C + row / rep) * a.H + head) * D + c, o.x * inv,
             o.y * inv, o.z * inv, o.w * inv);
    } else {
      const size_t pr = (((size_t)sp * a.B + b) * a.KVH + g) * rows + row;
      *reinterpret_cast<float4*>(a.part_o + pr * D + c) =
          make_float4(o.x * inv, o.y * inv, o.z * inv, o.w * inv);
      if (c == 0) a.part_lse[pr] = lsum > 0.f ? mmax + logf(lsum) : -INFINITY;
    }
  }
}

// Merge the splits' partials: one warp per (b, g, row). Splits where the
// row saw no key carry lse = -inf and weigh 0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(Args a, int TR) {
  const int rep = a.H / a.KVH, rows = a.C * rep;
  const size_t idx = (size_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (idx >= (size_t)a.B * a.KVH * rows) return;
  const int row = idx % rows;
  const int g = (idx / rows) % a.KVH;
  const int b = idx / ((size_t)rows * a.KVH);
  const int n = a.part_n[((size_t)b * a.KVH + g) * a.n_rt + row / TR];
  const size_t split_stride = (size_t)a.B * a.KVH * rows;
  float mmax = -INFINITY;
  for (int s = 0; s < n; ++s) mmax = fmaxf(mmax, a.part_lse[s * split_stride + idx]);
  float4 o[2] = {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
  float wsum = 0.f;
  if (mmax != -INFINITY) {
    for (int s = 0; s < n; ++s) {
      const float ls = a.part_lse[s * split_stride + idx];
      if (ls == -INFINITY) continue;
      const float w = expf(ls - mmax);
      wsum += w;
      const float* src = a.part_o + (s * split_stride + idx) * a.D;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = (lane + 32 * u) * 4;
        if (c >= a.D) break;
        const float4 v = *reinterpret_cast<const float4*>(src + c);
        o[u].x += w * v.x; o[u].y += w * v.y; o[u].z += w * v.z; o[u].w += w * v.w;
      }
    }
  }
  const float inv = wsum > 0.f ? 1.f / wsum : 0.f;
  const int head = g * rep + row % rep;
  T* dst = static_cast<T*>(a.out) + ((size_t)(b * a.C + row / rep) * a.H + head) * a.D;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int c = (lane + 32 * u) * 4;
    if (c >= a.D) break;
    store4(dst + c, o[u].x * inv, o[u].y * inv, o[u].z * inv, o[u].w * inv);
  }
}

template <typename T, int DMAX, int WR>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int NS = stages<T, DMAX, WR>();
  auto kern = paged_attention_kernel<T, DMAX, WR>;
  const size_t smem = smem_bytes<T>(16 * WR, DMAX, NS);   // the largest D of this build
  static bool smem_set = false;   // per instantiation: raise the opt-in cap once
  if (!smem_set && smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const dim3 grid(a.n_splits, a.KVH, a.B * a.n_rt);
  kern<<<grid, kThreads, smem_bytes<T>(16 * WR, a.D, NS), stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.n_splits == 1) return (int)e;
  const size_t warps = (size_t)a.B * a.KVH * a.C * (a.H / a.KVH);
  paged_combine_kernel<T><<<(unsigned)((warps + kWarps - 1) / kWarps), kThreads, 0, stream>>>(
      a, 16 * WR);
  return (int)cudaGetLastError();
}

template <typename T, int DMAX>
int launch_wr(const Args& a, int wr, cudaStream_t stream) {
  if (wr == 1) return launch<T, DMAX, 1>(a, stream);
  if (wr == 2) return launch<T, DMAX, 2>(a, stream);
  if (wr == 4) return launch<T, DMAX, 4>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// One specialization of paged::launch_d256 a part (1-6).
#define PAGED_D256(T, WR)                                                \
  template <>                                                            \
  int paged::launch_d256<T, WR>(const Args& a, cudaStream_t stream) {    \
    return launch<T, 256, WR>(a, stream);                                \
  }
#if PAGED_PART == 1
PAGED_D256(__nv_bfloat16, 1)
#endif
#if PAGED_PART == 2
PAGED_D256(__nv_bfloat16, 2)
#endif
#if PAGED_PART == 3
PAGED_D256(__nv_bfloat16, 4)
#endif
#if PAGED_PART == 4
PAGED_D256(float, 1)
#endif
#if PAGED_PART == 5
PAGED_D256(float, 2)
#endif
#if PAGED_PART == 6
PAGED_D256(float, 4)
#endif
#if PAGED_PART == 0
int paged::launch_bf16_d128(const Args& a, int wr, cudaStream_t stream) {
  return launch_wr<__nv_bfloat16, 128>(a, wr, stream);
}

namespace {
template <typename T>
int launch_d256_wr(const Args& a, int wr, cudaStream_t stream) {
  if (wr == 1) return paged::launch_d256<T, 1>(a, stream);
  if (wr == 2) return paged::launch_d256<T, 2>(a, stream);
  if (wr == 4) return paged::launch_d256<T, 4>(a, stream);
  return (int)cudaErrorInvalidValue;
}
}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 = float32,
// 1 = bfloat16. Returns the cudaError_t of the launches (0 = success).
// block_r in {16, 32, 64} is the block's row tile (4 warps as block_r / 16
// row tiles x 64 / block_r key slices). With n_splits > 1 the caller
// passes f32 scratch part_o [n_splits, B, KVH, C * H / KVH, D], part_lse
// [n_splits, B, KVH, C * H / KVH] and int part_n [B, KVH, row tiles];
// split_keys is a multiple of 64 up to 256. The caller has checked
// shapes: D % 8 == 0, D <= 256, H % KVH == 0, all tensors contiguous and
// 16-byte aligned.
extern "C" int paged_attention_fwd(const void* q, const void* k, const void* v,
                                   const int* block_tables, const int* q_positions,
                                   const int* lens, void* out, float* part_o,
                                   float* part_lse, int* part_n, int B, int C, int H,
                                   int KVH, int D, int bs, int T, int N, float sm_scale,
                                   int block_r, int n_splits, int split_keys, int dtype,
                                   void* stream) {
  if (block_r != 16 && block_r != 32 && block_r != 64) return (int)cudaErrorInvalidValue;
  if (split_keys <= 0 || split_keys % kBK || split_keys > kMaxSplitKeys || n_splits < 1 ||
      (n_splits > 1 && (!part_o || !part_lse || !part_n)))
    return (int)cudaErrorInvalidValue;
  const int rows = C * (H / KVH);
  Args a{q, k, v, block_tables, q_positions, lens, out, part_o, part_lse, part_n,
         B, C, H, KVH, D, bs, T, N, (rows + block_r - 1) / block_r, n_splits,
         split_keys, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int wr = block_r / 16;
  if (dtype == 1) {
    if (D <= 128) return paged::launch_bf16_d128(a, wr, s);
    return launch_d256_wr<__nv_bfloat16>(a, wr, s);
  }
  if (dtype == 0) return launch_d256_wr<float>(a, wr, s);   // tests only: one build
  return (int)cudaErrorInvalidValue;
}
#endif
