// mma.sync fragment helpers shared by the port's CUDA sources
// (flash_attention.cu, paged_attention.cu): the m16n8k16 bf16 tensor-core
// product with f32 accumulation, and an exact f32 emulation of the same
// fragments (warp shuffles and FMAs) so that one kernel source serves
// bf16 and f32 inputs.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------------------------ mma
// Fragments of mma.sync.m16n8k16 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"). With g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major): reg0 = A[g][2t..2t+1], reg1 = A[g+8][2t..],
//     reg2 = A[g][2t+8..], reg3 = A[g+8][2t+8..];
//   B (16 x 8): reg0 = B[2t..2t+1][g], reg1 = B[2t+8..2t+9][g];
//   C (16 x 8, f32): c0 = C[g][2t], c1 = C[g][2t+1], c2 = C[g+8][2t],
//     c3 = C[g+8][2t+1].
// The f32 variant keeps the same elements per lane, unpacked.
template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  using T = __nv_bfloat16;
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };

  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ uint32_t pair(const T* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  static __device__ __forceinline__ uint32_t pair_strided(const T* p, int stride) {
    const uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
    const uint32_t hi = *reinterpret_cast<const uint16_t*>(p + stride);
    return lo | (hi << 16);
  }
  // A tile: element (r, k) at s[r * ld + k]
  static __device__ __forceinline__ void load_a(A& a, const T* s, int ld, int lane) {
    const T* p = s + (lane >> 2) * ld + 2 * (lane & 3);
    a.r[0] = pair(p);
    a.r[1] = pair(p + 8 * ld);
    a.r[2] = pair(p + 8);
    a.r[3] = pair(p + 8 * ld + 8);
  }
  // B tile stored n-major: element (k, n) at s[n * ld + k]
  static __device__ __forceinline__ void load_b_nk(B& b, const T* s, int ld, int lane) {
    const T* p = s + (lane >> 2) * ld + 2 * (lane & 3);
    b.r[0] = pair(p);
    b.r[1] = pair(p + 8);
  }
  // B tile stored k-major: element (k, n) at s[k * ld + n]
  static __device__ __forceinline__ void load_b_kn(B& b, const T* s, int ld, int lane) {
    const T* p = s + 2 * (lane & 3) * ld + (lane >> 2);
    b.r[0] = pair_strided(p, ld);
    b.r[1] = pair_strided(p + 8 * ld, ld);
  }
  // Two B tiles (n-tiles n0 and n0 + 8) stored k-major, element (k, n) at
  // s[k * ld + n], with ldmatrix.trans: rows must start 16-byte aligned.
  static __device__ __forceinline__ void load_b_kn_x2(B& b0, B& b1, const T* s, int ld,
                                                      int lane) {
    const T* p = s + (lane & 15) * ld + (lane >> 4) * 8;
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(b0.r[0]), "=r"(b0.r[1]), "=r"(b1.r[0]), "=r"(b1.r[1])
        : "r"(addr));
  }
  // A from two C-layout tiles holding columns 0-7 and 8-15 (rounded to bf16)
  static __device__ __forceinline__ void a_from_c(A& a, const float* c0, const float* c1) {
    a.r[0] = pack(c0[0], c0[1]);
    a.r[1] = pack(c0[2], c0[3]);
    a.r[2] = pack(c1[0], c1[1]);
    a.r[3] = pack(c1[2], c1[3]);
  }
  static __device__ __forceinline__ void mma(float* c, const A& a, const B& b, int) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]),
          "r"(b.r[0]), "r"(b.r[1]));
  }
};

template <>
struct Mma<float> {
  using T = float;
  // r[2i], r[2i+1] are the two elements of register i of the bf16 layout
  struct A { float r[8]; };
  struct B { float r[4]; };

  static __device__ __forceinline__ void load_a(A& a, const T* s, int ld, int lane) {
    const T* p = s + (lane >> 2) * ld + 2 * (lane & 3);
    a.r[0] = p[0];          a.r[1] = p[1];
    a.r[2] = p[8 * ld];     a.r[3] = p[8 * ld + 1];
    a.r[4] = p[8];          a.r[5] = p[9];
    a.r[6] = p[8 * ld + 8]; a.r[7] = p[8 * ld + 9];
  }
  static __device__ __forceinline__ void load_b_nk(B& b, const T* s, int ld, int lane) {
    const T* p = s + (lane >> 2) * ld + 2 * (lane & 3);
    b.r[0] = p[0]; b.r[1] = p[1]; b.r[2] = p[8]; b.r[3] = p[9];
  }
  static __device__ __forceinline__ void load_b_kn(B& b, const T* s, int ld, int lane) {
    const T* p = s + 2 * (lane & 3) * ld + (lane >> 2);
    b.r[0] = p[0]; b.r[1] = p[ld]; b.r[2] = p[8 * ld]; b.r[3] = p[9 * ld];
  }
  static __device__ __forceinline__ void load_b_kn_x2(B& b0, B& b1, const T* s, int ld,
                                                      int lane) {
    load_b_kn(b0, s, ld, lane);
    load_b_kn(b1, s + 8, ld, lane);
  }
  static __device__ __forceinline__ void a_from_c(A& a, const float* c0, const float* c1) {
    a.r[0] = c0[0]; a.r[1] = c0[1]; a.r[2] = c0[2]; a.r[3] = c0[3];
    a.r[4] = c1[0]; a.r[5] = c1[1]; a.r[6] = c1[2]; a.r[7] = c1[3];
  }
  // C += A B in exact f32: lane (g, t) gathers row g and g+8 of A and
  // columns 2t, 2t+1 of B from the lanes that hold them.
  static __device__ __forceinline__ void mma(float* c, const A& a, const B& b, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int hi = k >> 3, e = k & 1, src = (k & 7) >> 1;
      const float a_lo = __shfl_sync(kFull, a.r[4 * hi + e], g * 4 + src);
      const float a_hi = __shfl_sync(kFull, a.r[4 * hi + 2 + e], g * 4 + src);
      const float b0 = __shfl_sync(kFull, b.r[2 * hi + e], (2 * t) * 4 + src);
      const float b1 = __shfl_sync(kFull, b.r[2 * hi + e], (2 * t + 1) * 4 + src);
      c[0] = fmaf(a_lo, b0, c[0]);
      c[1] = fmaf(a_lo, b1, c[1]);
      c[2] = fmaf(a_hi, b0, c[2]);
      c[3] = fmaf(a_hi, b1, c[3]);
    }
  }
};

template <typename T>
__device__ __forceinline__ T to_t(float x);
template <>
__device__ __forceinline__ float to_t<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_t<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

}  // namespace
