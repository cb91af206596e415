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
// What bounds it: bytes. Decode reads every live K/V page once per
// (sequence, kv head) and does ~2 flops per byte it reads, far below the
// ~295 flops/byte at which the tensor cores would become the limit.
// Chunked prefill reuses each staged page across its row block, and
// there the scalar f32 FMAs below are the limit.
//
// Design: the Pallas grid (b, g, row block, table slot) runs its slot
// axis in order on one core and carries m/l/acc in VMEM across it. CUDA
// blocks share no state, so the slot axis becomes a loop inside the
// block: one block per (row block, kv head g, sequence b). The block
// reads lens[b] and block_tables[b, t] itself (there is no scalar
// prefetch), and stops at the last live page and at the last page any of
// its rows may see (causal skip). Each page's [bs, D] slice of K and V
// for head g is staged in shared memory once and read by every row of
// the block. Inside a warp, lane j scores key j of the page (bs <= 32),
// so the softmax over a page is one warp reduction; for P.V each lane
// owns four-element chunks of the head dim. GQA regroups q rows per kv
// head in the index math (row r of head g is token r / rep, head
// g * rep + r % rep): the cache is never repeated and q is never copied.
// Later work: wgmma, TMA/cp.async double buffering, split-K over pages
// for decode.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerWarp = 4;   // query rows a warp scores together
constexpr int kMaxChunks = 2;     // float4 chunks of the head dim per lane: D <= 256
constexpr int kPad = 4;           // padding elements per staged K/V row (bank spread)
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    float4 f;
    f.x = __uint_as_float(u.x << 16);
    f.y = __uint_as_float(u.x & 0xffff0000u);
    f.z = __uint_as_float(u.y << 16);
    f.w = __uint_as_float(u.y & 0xffff0000u);
    return f;
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  static __device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
    __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&a);
    u.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = u;
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* block_tables;
  const int* q_positions;
  const int* lens;
  void* out;
  int C, H, KVH, D, bs, T, N, block_r;
  float sm_scale;
};

template <typename T>
__global__ void paged_attention_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int pos_s[32];

  const int R = a.block_r;
  const int D = a.D;
  const int ld = D + kPad;                 // staged K/V row stride (elements)
  float* q_s = reinterpret_cast<float*>(smem);                  // [R, D] f32
  T* k_s = reinterpret_cast<T*>(smem + sizeof(float) * R * D);  // [bs, ld]
  T* v_s = k_s + a.bs * ld;                                     // [bs, ld]

  const int rb = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int rep = a.H / a.KVH;
  const int rows = a.C * rep;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* q = static_cast<const T*>(a.q);
  const T* kc = static_cast<const T*>(a.k);
  const T* vc = static_cast<const T*>(a.v);
  T* out = static_cast<T*>(a.out);

  // -- stage this block's query rows (f32) and their positions
  for (int r = tid; r < R; r += blockDim.x) {
    const int row = rb * R + r;
    pos_s[r] = row < rows ? a.q_positions[b * a.C + row / rep] : -1;
  }
  const int d4 = D / 4;
  for (int i = tid; i < R * d4; i += blockDim.x) {
    const int r = i / d4, c = (i % d4) * 4;
    const int row = rb * R + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < rows) {
      const int head = g * rep + row % rep;
      const size_t off = ((size_t)(b * a.C + row / rep) * a.H + head) * D + c;
      val = Elem<T>::load4(q + off);
    }
    *reinterpret_cast<float4*>(q_s + r * D + c) = val;
  }
  __syncthreads();

  int max_pos = -1;
  for (int r = 0; r < R; ++r) max_pos = max(max_pos, pos_s[r]);
  int n_pages = max((a.lens[b] + a.bs - 1) / a.bs, 1);
  n_pages = min(n_pages, a.T);
  // causal skip: no row of this block sees a key past max_pos
  n_pages = min(n_pages, max_pos >= 0 ? max_pos / a.bs + 1 : 1);

  const int n_warps_rows = (R + kRowsPerWarp - 1) / kRowsPerWarp;
  const bool computes = warp < n_warps_rows;
  int my_pos[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp];
  float4 acc[kRowsPerWarp][kMaxChunks];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    my_pos[i] = (computes && r < R) ? pos_s[r] : -1;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // 16-byte copy units per staged row
  constexpr int kVec = 16 / sizeof(T);
  const int units = D / kVec;
  const size_t row_stride = (size_t)a.KVH * D;     // pool elements between slots

  for (int t = 0; t < n_pages; ++t) {
    int blk = a.block_tables[b * a.T + t];
    blk = min(max(blk, 0), a.N - 1);
    __syncthreads();   // every warp is done with the previous page
    const size_t base = (size_t)blk * a.bs * row_stride + (size_t)g * D;
    for (int i = tid; i < a.bs * units; i += blockDim.x) {
      const int s = i / units, c = (i % units) * kVec;
      const size_t src = base + s * row_stride + c;
      const uint4 kk = *reinterpret_cast<const uint4*>(kc + src);
      const uint4 vv = *reinterpret_cast<const uint4*>(vc + src);
      // rows of the staged page are only 8-byte aligned: two 8-byte stores
      uint2* kd = reinterpret_cast<uint2*>(k_s + s * ld + c);
      uint2* vd = reinterpret_cast<uint2*>(v_s + s * ld + c);
      kd[0] = make_uint2(kk.x, kk.y);
      kd[1] = make_uint2(kk.z, kk.w);
      vd[0] = make_uint2(vv.x, vv.y);
      vd[1] = make_uint2(vv.z, vv.w);
    }
    __syncthreads();
    if (!computes) continue;

    // -- scores: lane j scores key j of the page against the warp's rows
    const int key0 = t * a.bs;
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
    if (lane < a.bs) {
      const T* krow = k_s + lane * ld;
      const float* qw = q_s + warp * kRowsPerWarp * D;
      for (int c = 0; c < D; c += 4) {
        const float4 kf = Elem<T>::load4(krow + c);
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          if (warp * kRowsPerWarp + i >= R) break;
          const float4 qf = *reinterpret_cast<const float4*>(qw + i * D + c);
          s[i] = fmaf(qf.x, kf.x, s[i]);
          s[i] = fmaf(qf.y, kf.y, s[i]);
          s[i] = fmaf(qf.z, kf.z, s[i]);
          s[i] = fmaf(qf.w, kf.w, s[i]);
        }
      }
    }

    // -- online softmax over this page (values replicated across lanes)
    float p[kRowsPerWarp];
    int warp_max_pos = -1;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      warp_max_pos = max(warp_max_pos, my_pos[i]);
      const bool valid = lane < a.bs && key0 + lane <= my_pos[i];
      const float sv = valid ? s[i] * a.sm_scale : -INFINITY;
      const float m_new = fmaxf(m[i], warp_max(sv));
      if (m_new == -INFINITY) {   // no key seen yet by this row
        p[i] = 0.f;
        continue;
      }
      const float alpha = expf(m[i] - m_new);
      const float pv = valid ? expf(sv - m_new) : 0.f;
      l[i] = l[i] * alpha + warp_sum(pv);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        acc[i][c].x *= alpha;
        acc[i][c].y *= alpha;
        acc[i][c].z *= alpha;
        acc[i][c].w *= alpha;
      }
      p[i] = Elem<T>::round(pv);
    }

    // -- P.V: each lane owns head-dim chunks lane*4 and (lane+32)*4
    const int n_keys = min(a.bs, warp_max_pos - key0 + 1);
    for (int j = 0; j < n_keys; ++j) {
      float pj[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) pj[i] = __shfl_sync(kFull, p[i], j);
      const T* vrow = v_s + j * ld;
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        const int col = (lane + 32 * c) * 4;
        if (col >= D) break;
        const float4 vf = Elem<T>::load4(vrow + col);
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          acc[i][c].x = fmaf(pj[i], vf.x, acc[i][c].x);
          acc[i][c].y = fmaf(pj[i], vf.y, acc[i][c].y);
          acc[i][c].z = fmaf(pj[i], vf.z, acc[i][c].z);
          acc[i][c].w = fmaf(pj[i], vf.w, acc[i][c].w);
        }
      }
    }
  }

  if (!computes) return;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    const int row = rb * R + r;
    if (r >= R || row >= rows) break;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    const int head = g * rep + row % rep;
    T* orow = out + ((size_t)(b * a.C + row / rep) * a.H + head) * D;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      const int col = (lane + 32 * c) * 4;
      if (col >= D) break;
      const float4 o = make_float4(acc[i][c].x * inv, acc[i][c].y * inv,
                                   acc[i][c].z * inv, acc[i][c].w * inv);
      Elem<T>::store4(orow + col, o);
    }
  }
}

template <typename T>
int launch(const Args& a, int B, cudaStream_t stream) {
  const int warps = max((a.block_r + kRowsPerWarp - 1) / kRowsPerWarp, 4);
  const size_t smem = sizeof(float) * a.block_r * a.D +
                      2 * sizeof(T) * a.bs * (a.D + kPad);
  static size_t smem_set = 0;   // per instantiation: raise the opt-in cap once
  if (smem > 48 * 1024 && smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const int rows = a.C * (a.H / a.KVH);
  const dim3 grid((rows + a.block_r - 1) / a.block_r, a.KVH, B);
  paged_attention_kernel<T><<<grid, 32 * warps, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 = float32,
// 1 = bfloat16. Returns the cudaError_t of the launch (0 = success). The
// caller has checked shapes: D % 8 == 0, D <= 256, bs <= 32,
// block_r % 4 == 0, block_r <= 32, H % KVH == 0, all tensors contiguous.
extern "C" int paged_attention_fwd(const void* q, const void* k, const void* v,
                                   const int* block_tables, const int* q_positions,
                                   const int* lens, void* out, int B, int C, int H,
                                   int KVH, int D, int bs, int T, int N,
                                   float sm_scale, int block_r, int dtype,
                                   void* stream) {
  Args a{q, k, v, block_tables, q_positions, lens, out,
         C, H, KVH, D, bs, T, N, block_r, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, B, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, B, s);
  return (int)cudaErrorInvalidValue;
}
