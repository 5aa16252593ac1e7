// Fused number-theoretic transforms for NVIDIA Hopper, called from JAX
// through the XLA foreign function interface (ringsnark_tpu/ops/ntt_gpu.py).
//
// One thread block transforms one row of m <= 2^15 uint32 residues.  The row
// is loaded into shared memory once (at most 128 KiB; a Hopper block may use
// 227 KiB), all log2(m) butterfly stages run there separated by block
// barriers, and the row is written back once: two passes over device memory
// instead of the plain path's two per stage.
//
// Orderings and arithmetic match ops/ntt.py bit for bit:
//   forward: Gentleman-Sande DIF, natural in -> bit-reversed out; stage with
//            half-width d pairs (j*2d+i, j*2d+d+i) and multiplies the
//            difference by w^(i*m/(2d));
//   inverse: Cooley-Tukey DIT, bit-reversed in -> natural out, twiddles
//            w^-(i*m/(2d)).
// Twiddles live in one flat table per limb: entry d-1+i holds the stage-d
// twiddle i, so each stage reads a contiguous slice.  Products use Shoup's
// precomputed quotient: q = umulhi(a, w_sh), r = a*w - q*p in [0, 2p), one
// conditional subtract (p < 2^31).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I<jax.ffi.include_dir()> (see native/Makefile).

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kMaxLogM = 15;

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b,
                                            uint32_t p) {
  const uint32_t s = a + b;
  return s >= p ? s - p : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b,
                                            uint32_t p) {
  const uint32_t d = a + p - b;
  return d >= p ? d - p : d;
}

// a * w mod p for w < p < 2^31 and w_sh = floor(w * 2^32 / p)
__device__ __forceinline__ uint32_t shoup_mul(uint32_t a, uint32_t w,
                                              uint32_t w_sh, uint32_t p) {
  const uint32_t q = __umulhi(a, w_sh);
  const uint32_t r = a * w - q * p;
  return r >= p ? r - p : r;
}

// x, out: [rows, m]; row r belongs to limb (r / rows_per_limb) % L.
// tw, tw_sh: [L, m] flat stage twiddles; scale, scale_sh: [L, m] per-position
// factors applied before the stages (pre) or after them (post).
template <bool kInverse>
__global__ void ntt_rows_kernel(const uint32_t* __restrict__ x,
                                uint32_t* __restrict__ out,
                                const uint32_t* __restrict__ tw,
                                const uint32_t* __restrict__ tw_sh,
                                const uint32_t* __restrict__ scale,
                                const uint32_t* __restrict__ scale_sh,
                                const uint32_t* __restrict__ primes, int L,
                                int log_m, int rows_per_limb, bool pre,
                                bool post) {
  extern __shared__ uint32_t s[];
  const int m = 1 << log_m;
  const int half = m >> 1;
  const size_t row = blockIdx.x;
  const int l = static_cast<int>((row / rows_per_limb) % L);
  const uint32_t p = primes[l];
  const uint32_t* tw_l = tw + static_cast<size_t>(l) * m;
  const uint32_t* tw_sh_l = tw_sh + static_cast<size_t>(l) * m;
  const uint32_t* sc_l = scale + static_cast<size_t>(l) * m;
  const uint32_t* sc_sh_l = scale_sh + static_cast<size_t>(l) * m;
  const uint32_t* x_r = x + row * m;
  uint32_t* out_r = out + row * m;

  for (int k = threadIdx.x; k < m; k += blockDim.x) {
    const uint32_t v = x_r[k];
    s[k] = pre ? shoup_mul(v, sc_l[k], sc_sh_l[k], p) : v;
  }
  __syncthreads();

  for (int st = 0; st < log_m; ++st) {
    const int lg = kInverse ? st : log_m - 1 - st;
    const int d = 1 << lg;
    for (int t = threadIdx.x; t < half; t += blockDim.x) {
      const int i = t & (d - 1);
      const int ia = ((t >> lg) << (lg + 1)) + i;
      const uint32_t w = tw_l[d - 1 + i];
      const uint32_t w_sh = tw_sh_l[d - 1 + i];
      const uint32_t a = s[ia];
      const uint32_t b = s[ia + d];
      if (kInverse) {
        const uint32_t tb = shoup_mul(b, w, w_sh, p);
        s[ia] = add_mod(a, tb, p);
        s[ia + d] = sub_mod(a, tb, p);
      } else {
        s[ia] = add_mod(a, b, p);
        s[ia + d] = shoup_mul(sub_mod(a, b, p), w, w_sh, p);
      }
    }
    __syncthreads();
  }

  for (int k = threadIdx.x; k < m; k += blockDim.x) {
    const uint32_t v = s[k];
    out_r[k] = post ? shoup_mul(v, sc_l[k], sc_sh_l[k], p) : v;
  }
}

// The outer stages of the four-step split of a size-M transform viewed as
// [R, Mi] (M = R * Mi): the stages whose butterflies pair whole rows (half-
// width d = dr * Mi for dr = R/2 .. 1).  One block loads an [R, cols] column
// tile of one outer row (b, l), runs those stages in shared memory and writes
// the tile back; the Mi-length rows then go through ntt_rows_kernel.
// tw, tw_sh: [L, M] flat stage twiddles of the full size-M transform (the
// entries d-1+i with d >= Mi are read); scale, scale_sh: [L, M].
template <bool kInverse>
__global__ void ntt_cols_kernel(const uint32_t* __restrict__ x,
                                uint32_t* __restrict__ out,
                                const uint32_t* __restrict__ tw,
                                const uint32_t* __restrict__ tw_sh,
                                const uint32_t* __restrict__ scale,
                                const uint32_t* __restrict__ scale_sh,
                                const uint32_t* __restrict__ primes, int L,
                                int log_r, int log_mi, int log_cols, bool pre,
                                bool post) {
  extern __shared__ uint32_t s[];
  const int R = 1 << log_r;
  const int mi = 1 << log_mi;
  const int cols = 1 << log_cols;
  const size_t m = static_cast<size_t>(R) << log_mi;
  const int tiles = mi >> log_cols;  // column tiles per outer row
  const size_t outer = blockIdx.x / tiles;
  const int c0 = (blockIdx.x % tiles) << log_cols;
  const int l = static_cast<int>(outer % L);
  const uint32_t p = primes[l];
  const uint32_t* tw_l = tw + l * m;
  const uint32_t* tw_sh_l = tw_sh + l * m;
  const uint32_t* sc_l = scale + l * m;
  const uint32_t* sc_sh_l = scale_sh + l * m;
  const uint32_t* x_o = x + outer * m;
  uint32_t* out_o = out + outer * m;
  const int tile = R << log_cols;

  for (int k = threadIdx.x; k < tile; k += blockDim.x) {
    const size_t g = (static_cast<size_t>(k >> log_cols) << log_mi) + c0 +
                     (k & (cols - 1));
    const uint32_t v = x_o[g];
    s[k] = pre ? shoup_mul(v, sc_l[g], sc_sh_l[g], p) : v;
  }
  __syncthreads();

  const int half = tile >> 1;
  for (int st = 0; st < log_r; ++st) {
    const int lg = kInverse ? st : log_r - 1 - st;  // log2 of dr
    const int dr = 1 << lg;
    for (int t = threadIdx.x; t < half; t += blockDim.x) {
      const int cc = t & (cols - 1);
      const int rr = t >> log_cols;
      const int ir = rr & (dr - 1);
      const int ra = ((rr >> lg) << (lg + 1)) + ir;
      const int ia = (ra << log_cols) + cc;
      const int ib = ia + (dr << log_cols);
      // stage half-width d = dr * mi; butterfly index i = ir * mi + column
      const size_t e = (static_cast<size_t>(dr) << log_mi) - 1 +
                       (static_cast<size_t>(ir) << log_mi) + c0 + cc;
      const uint32_t w = tw_l[e];
      const uint32_t w_sh = tw_sh_l[e];
      const uint32_t a = s[ia];
      const uint32_t b = s[ib];
      if (kInverse) {
        const uint32_t tb = shoup_mul(b, w, w_sh, p);
        s[ia] = add_mod(a, tb, p);
        s[ib] = sub_mod(a, tb, p);
      } else {
        s[ia] = add_mod(a, b, p);
        s[ib] = shoup_mul(sub_mod(a, b, p), w, w_sh, p);
      }
    }
    __syncthreads();
  }

  for (int k = threadIdx.x; k < tile; k += blockDim.x) {
    const size_t g = (static_cast<size_t>(k >> log_cols) << log_mi) + c0 +
                     (k & (cols - 1));
    const uint32_t v = s[k];
    out_o[g] = post ? shoup_mul(v, sc_l[g], sc_sh_l[g], p) : v;
  }
}

int log2_exact(int64_t n) {
  int lg = 0;
  while ((int64_t{1} << lg) < n) ++lg;
  return (int64_t{1} << lg) == n ? lg : -1;
}

int block_threads(int64_t butterflies) {
  if (butterflies > 512) return 512;
  return butterflies < 32 ? 32 : static_cast<int>(butterflies);
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

bool tables_ok(int64_t L, int64_t n, ffi::Buffer<ffi::U32>& tw,
               ffi::Buffer<ffi::U32>& tw_sh, ffi::Buffer<ffi::U32>& scale,
               ffi::Buffer<ffi::U32>& scale_sh) {
  const size_t want = static_cast<size_t>(L * n);
  return L >= 1 && tw.element_count() == want &&
         tw_sh.element_count() == want && scale.element_count() == want &&
         scale_sh.element_count() == want;
}

ffi::Error status(cudaError_t err) {
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

ffi::Error NttRowsImpl(cudaStream_t stream, ffi::Buffer<ffi::U32> x,
                       ffi::Buffer<ffi::U32> tw, ffi::Buffer<ffi::U32> tw_sh,
                       ffi::Buffer<ffi::U32> scale,
                       ffi::Buffer<ffi::U32> scale_sh,
                       ffi::Buffer<ffi::U32> primes,
                       ffi::ResultBuffer<ffi::U32> out, int32_t inverse,
                       int32_t pre, int32_t post, int32_t rows_per_limb) {
  const auto dims = x.dimensions();
  if (dims.size() < 1) {
    return ffi::Error::InvalidArgument("ntt rows: input needs a row axis");
  }
  const int64_t m = dims.back();
  const int log_m = log2_exact(m);
  if (m < 2 || log_m < 0 || log_m > kMaxLogM) {
    return ffi::Error::InvalidArgument(
        "ntt rows: row length must be a power of two in [2, 2^15]");
  }
  const int L = static_cast<int>(primes.element_count());
  if (!tables_ok(L, m, tw, tw_sh, scale, scale_sh) || rows_per_limb < 1) {
    return ffi::Error::InvalidArgument("ntt rows: tables must be [L, m]");
  }
  const int64_t rows = static_cast<int64_t>(x.element_count()) / m;
  if (rows == 0) return ffi::Error::Success();
  if (rows > 0x7fffffff) {
    return ffi::Error::InvalidArgument("ntt rows: too many rows");
  }
  const size_t smem = static_cast<size_t>(m) * sizeof(uint32_t);
  const int threads = block_threads(m / 2);
  auto kernel = inverse ? ntt_rows_kernel<true> : ntt_rows_kernel<false>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return status(err);
  kernel<<<static_cast<unsigned>(rows), threads, smem, stream>>>(
      x.typed_data(), out->typed_data(), tw.typed_data(), tw_sh.typed_data(),
      scale.typed_data(), scale_sh.typed_data(), primes.typed_data(), L, log_m,
      rows_per_limb, pre != 0, post != 0);
  return status(cudaGetLastError());
}

ffi::Error NttColsImpl(cudaStream_t stream, ffi::Buffer<ffi::U32> x,
                       ffi::Buffer<ffi::U32> tw, ffi::Buffer<ffi::U32> tw_sh,
                       ffi::Buffer<ffi::U32> scale,
                       ffi::Buffer<ffi::U32> scale_sh,
                       ffi::Buffer<ffi::U32> primes,
                       ffi::ResultBuffer<ffi::U32> out, int32_t inverse,
                       int32_t pre, int32_t post, int32_t inner_m,
                       int32_t cols) {
  const auto dims = x.dimensions();
  if (dims.size() < 1) {
    return ffi::Error::InvalidArgument("ntt cols: input needs a row axis");
  }
  const int64_t m = dims.back();
  const int log_m = log2_exact(m);
  const int log_mi = log2_exact(inner_m);
  const int log_cols = log2_exact(cols);
  if (log_m < 0 || log_mi < 0 || log_cols < 0 || log_mi >= log_m ||
      log_cols > log_mi) {
    return ffi::Error::InvalidArgument(
        "ntt cols: need powers of two cols <= inner_m < m");
  }
  const int log_r = log_m - log_mi;
  const int64_t tile = int64_t{1} << (log_r + log_cols);
  if (tile > (int64_t{1} << kMaxLogM)) {
    return ffi::Error::InvalidArgument("ntt cols: tile exceeds 2^15");
  }
  const int L = static_cast<int>(primes.element_count());
  if (!tables_ok(L, m, tw, tw_sh, scale, scale_sh)) {
    return ffi::Error::InvalidArgument("ntt cols: tables must be [L, m]");
  }
  const int64_t outer = static_cast<int64_t>(x.element_count()) / m;
  if (outer == 0) return ffi::Error::Success();
  const int64_t blocks = outer * (inner_m / cols);
  if (blocks > 0x7fffffff) {
    return ffi::Error::InvalidArgument("ntt cols: too many tiles");
  }
  const size_t smem = static_cast<size_t>(tile) * sizeof(uint32_t);
  const int threads = block_threads(tile / 2);
  auto kernel = inverse ? ntt_cols_kernel<true> : ntt_cols_kernel<false>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return status(err);
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      x.typed_data(), out->typed_data(), tw.typed_data(), tw_sh.typed_data(),
      scale.typed_data(), scale_sh.typed_data(), primes.typed_data(), L, log_r,
      log_mi, log_cols, pre != 0, post != 0);
  return status(cudaGetLastError());
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(RingsnarkNttRows, NttRowsImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()  // x
                                  .Arg<ffi::Buffer<ffi::U32>>()  // tw
                                  .Arg<ffi::Buffer<ffi::U32>>()  // tw_sh
                                  .Arg<ffi::Buffer<ffi::U32>>()  // scale
                                  .Arg<ffi::Buffer<ffi::U32>>()  // scale_sh
                                  .Arg<ffi::Buffer<ffi::U32>>()  // primes
                                  .Ret<ffi::Buffer<ffi::U32>>()  // out
                                  .Attr<int32_t>("inverse")
                                  .Attr<int32_t>("pre")
                                  .Attr<int32_t>("post")
                                  .Attr<int32_t>("rows_per_limb"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(RingsnarkNttCols, NttColsImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()  // x
                                  .Arg<ffi::Buffer<ffi::U32>>()  // tw
                                  .Arg<ffi::Buffer<ffi::U32>>()  // tw_sh
                                  .Arg<ffi::Buffer<ffi::U32>>()  // scale
                                  .Arg<ffi::Buffer<ffi::U32>>()  // scale_sh
                                  .Arg<ffi::Buffer<ffi::U32>>()  // primes
                                  .Ret<ffi::Buffer<ffi::U32>>()  // out
                                  .Attr<int32_t>("inverse")
                                  .Attr<int32_t>("pre")
                                  .Attr<int32_t>("post")
                                  .Attr<int32_t>("inner_m")
                                  .Attr<int32_t>("cols"));
