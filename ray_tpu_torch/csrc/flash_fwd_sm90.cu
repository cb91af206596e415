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
// __grid_constant__ kernel parameters.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// ------------------------------------------------------------ primitives
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 =
// 128B swizzle. K-major (Q, K): rows of 128 bytes, 8-row groups 1024
// bytes apart (SBO), LBO unused. MN-major (V): 64-column boxes LBO apart,
// 8-key groups 1024 bytes apart (SBO).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accesses of wgmma accumulators across
// the asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]: A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128]: A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 256] += A[64 x 16] B[16 x 256]: A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_m64n256(float (&d)[128], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127 "
      "}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (HD == 64) wgmma_rs_m64n64(o, a, db);
  else if constexpr (HD == 128) wgmma_rs_m64n128(o, a, db);
  else wgmma_rs_m64n256(o, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

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
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [B, S, H, D] bf16 as a 4-D map (D, H, S, B), box 64 columns x 1 head x
// 64 rows x 1 batch, 128-byte swizzle, zero fill out of bounds.
int encode(CUtensorMap* map, const void* ptr, int B, int S, int H, int D) {
  const EncodeTiled fn = encoder();
  if (!fn) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                        dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

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
