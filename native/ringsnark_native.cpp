// ringsnark-tpu native support library (C++17, no external dependencies).
//
// Role (DESIGN.md §6): the golden oracle and single-core CPU baseline for the
// JAX compute path — the stand-in for the reference's SEAL backend
// (whose submodules are empty and unbuildable).  Implements the same spec as
// ops/modops.py and ops/ntt.py with scalar 64-bit code: Barrett/plain modular
// arithmetic, negacyclic/cyclic NTT in the identical bit-reversal-free
// DIF/DIT ordering, pointwise ring ops, and ciphertext-plaintext
// inner-product accumulation.
//
// Exposed as a C ABI for ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

using u32 = uint32_t;
using u64 = uint64_t;
using u128 = unsigned __int128;

static inline u32 mulmod(u32 a, u32 b, u32 p) {
  return (u32)(((u64)a * b) % p);
}

static inline u32 addmod(u32 a, u32 b, u32 p) {
  u32 s = a + b;  // a,b < p < 2^31: no wrap
  return s >= p ? s - p : s;
}

static inline u32 submod(u32 a, u32 b, u32 p) { return addmod(a, p - b, p); }

static u32 powmod(u32 a, u64 e, u32 p) {
  u64 acc = 1, base = a % p;
  while (e) {
    if (e & 1) acc = acc * base % p;
    base = base * base % p;
    e >>= 1;
  }
  return (u32)acc;
}

extern "C" {

// ---- scalar modular arithmetic (oracle for ops/modops.py) -----------------

// Thread control for the multi-core ("single-socket") baseline legs: the
// reference is OpenMP-parallel, so honest vs-CPU ratios must be measured
// against all cores as well as one (BASELINE.md "≥10x over single-socket").
void rn_set_threads(int n) {
#ifdef _OPENMP
  omp_set_num_threads(n);
#else
  (void)n;
#endif
}

int rn_get_max_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

u32 rn_mulmod(u32 a, u32 b, u32 p) { return mulmod(a, b, p); }
u32 rn_powmod(u32 a, u64 e, u32 p) { return powmod(a, e, p); }
u32 rn_invmod(u32 a, u32 p) { return powmod(a, p - 2, p); }

// elementwise vectors
void rn_vec_mulmod(const u32* a, const u32* b, u32* out, u64 n, u32 p) {
  for (u64 i = 0; i < n; i++) out[i] = mulmod(a[i], b[i], p);
}
void rn_vec_addmod(const u32* a, const u32* b, u32* out, u64 n, u32 p) {
  for (u64 i = 0; i < n; i++) out[i] = addmod(a[i], b[i], p);
}

// ---- NTT ------------------------------------------------------------------
// Identical ordering to ops/ntt.py: forward = DIF (natural in, bit-reversed
// out), inverse = DIT (bit-reversed in, natural out, scaled by M^-1).
// w = primitive M-th root, psi = primitive 2M-th root with psi^2 = w.

// Shoup premultiplied twiddles: for fixed w, w' = floor(w*2^32/p) gives
//   hi = (x*w') >> 32;  r = x*w - hi*p  (all u32/u64 lo ops), r in [0, 2p)
// — one 64-bit multiply + one 32-bit multiply per butterfly instead of a
// u64 `%` (~20-40 cycles).  This is the same butterfly SEAL/polytools run
// on the host, so the CPU baseline is not artificially slow.
static inline u32 shoup_mul(u32 x, u32 w, u32 wsh, u32 p) {
  u32 hi = (u32)(((u64)x * wsh) >> 32);
  u32 r = x * w - hi * p;  // mod 2^32; true value in [0, 2p)
  return r >= p ? r - p : r;
}

static inline u32 shoup_pre(u32 w, u32 p) {
  return (u32)((((u64)w) << 32) / p);
}

struct NttTables {
  u32 p;
  u32 M;
  std::vector<u32> w_pows, winv_pows, psi_pows, psiinv_scaled;
  std::vector<u32> w_sh, winv_sh, psi_sh, psiinv_scaled_sh;
  u32 minv;
};

static void make_tables(NttTables& t, u32 p, u32 M, u32 w, u32 psi) {
  t.p = p;
  t.M = M;
  t.w_pows.resize(M);
  t.winv_pows.resize(M);
  t.w_sh.resize(M);
  t.winv_sh.resize(M);
  u32 winv = powmod(w, p - 2, p);
  t.w_pows[0] = t.winv_pows[0] = 1;
  for (u32 i = 1; i < M; i++) {
    t.w_pows[i] = mulmod(t.w_pows[i - 1], w, p);
    t.winv_pows[i] = mulmod(t.winv_pows[i - 1], winv, p);
  }
  for (u32 i = 0; i < M; i++) {
    t.w_sh[i] = shoup_pre(t.w_pows[i], p);
    t.winv_sh[i] = shoup_pre(t.winv_pows[i], p);
  }
  t.minv = powmod(M, p - 2, p);
  if (psi) {
    t.psi_pows.resize(M);
    t.psiinv_scaled.resize(M);
    t.psi_sh.resize(M);
    t.psiinv_scaled_sh.resize(M);
    u32 psiinv = powmod(psi, p - 2, p);
    t.psi_pows[0] = 1;
    t.psiinv_scaled[0] = t.minv;
    for (u32 i = 1; i < M; i++) {
      t.psi_pows[i] = mulmod(t.psi_pows[i - 1], psi, p);
      t.psiinv_scaled[i] = mulmod(t.psiinv_scaled[i - 1], psiinv, p);
    }
    for (u32 i = 0; i < M; i++) {
      t.psi_sh[i] = shoup_pre(t.psi_pows[i], p);
      t.psiinv_scaled_sh[i] = shoup_pre(t.psiinv_scaled[i], p);
    }
  }
}

static void dif_forward(u32* x, const NttTables& t) {
  const u32 p = t.p, M = t.M;
  for (u32 d = M >> 1, stride = 1; d >= 1; d >>= 1, stride <<= 1) {
    for (u32 blk = 0; blk < M; blk += 2 * d) {
      for (u32 i = 0; i < d; i++) {
        u64 ti = (u64)i * stride;
        u32 a = x[blk + i], b = x[blk + i + d];
        x[blk + i] = addmod(a, b, p);
        x[blk + i + d] =
            shoup_mul(submod(a, b, p), t.w_pows[ti], t.w_sh[ti], p);
      }
    }
  }
}

static void dit_inverse(u32* x, const NttTables& t) {
  const u32 p = t.p, M = t.M;
  for (u32 d = 1, stride = M >> 1; d <= M >> 1; d <<= 1, stride >>= 1) {
    for (u32 blk = 0; blk < M; blk += 2 * d) {
      for (u32 i = 0; i < d; i++) {
        u64 ti = (u64)i * stride;
        u32 a = x[blk + i];
        u32 b = shoup_mul(x[blk + i + d], t.winv_pows[ti], t.winv_sh[ti], p);
        x[blk + i] = addmod(a, b, p);
        x[blk + i + d] = submod(a, b, p);
      }
    }
  }
}

// batched negacyclic forward NTT in place: data[batch][M]
void rn_negacyclic_ntt(u32* data, u64 batch, u32 M, u32 p, u32 w, u32 psi) {
  NttTables t;
  make_tables(t, p, M, w, psi);
#pragma omp parallel for schedule(static)
  for (u64 b = 0; b < batch; b++) {
    u32* x = data + b * M;
    for (u32 i = 0; i < M; i++)
      x[i] = shoup_mul(x[i], t.psi_pows[i], t.psi_sh[i], p);
    dif_forward(x, t);
  }
}

// batched negacyclic inverse NTT in place
void rn_negacyclic_intt(u32* data, u64 batch, u32 M, u32 p, u32 w, u32 psi) {
  NttTables t;
  make_tables(t, p, M, w, psi);
#pragma omp parallel for schedule(static)
  for (u64 b = 0; b < batch; b++) {
    u32* x = data + b * M;
    dit_inverse(x, t);
    for (u32 i = 0; i < M; i++)
      x[i] = shoup_mul(x[i], t.psiinv_scaled[i], t.psiinv_scaled_sh[i], p);
  }
}

// batched cyclic forward / inverse
void rn_cyclic_ntt(u32* data, u64 batch, u32 M, u32 p, u32 w) {
  NttTables t;
  make_tables(t, p, M, w, 0);
#pragma omp parallel for schedule(static)
  for (u64 b = 0; b < batch; b++) dif_forward(data + b * M, t);
}

void rn_cyclic_intt(u32* data, u64 batch, u32 M, u32 p, u32 w) {
  NttTables t;
  make_tables(t, p, M, w, 0);
  const u32 minv_sh = shoup_pre(t.minv, p);
#pragma omp parallel for schedule(static)
  for (u64 b = 0; b < batch; b++) {
    u32* x = data + b * M;
    dit_inverse(x, t);
    for (u32 i = 0; i < M; i++) x[i] = shoup_mul(x[i], t.minv, minv_sh, p);
  }
}

// ---- fused ciphertext-plaintext inner product ----------------------------
// acc[j] += sum_b ct[b][j] * pt[b][j]  (one limb; lazy u128 accumulation).
// Loop order: b outer, j inner over a thread-owned contiguous j-range —
// ct rows stream sequentially (prefetch-friendly) and the u128
// accumulators stay cache-resident.  The j-outer form (r4/r5-early) paid a
// 16 KB stride per access and ran ~4x slower — a weaker CPU baseline would
// flatter the accelerator ratios, so the strongest reasonable form is used.
void rn_ip_accumulate(const u32* ct, const u32* pt, u32* acc, u64 batch,
                      u64 n, u32 p) {
#pragma omp parallel
  {
#ifdef _OPENMP
    u64 nt = (u64)omp_get_num_threads(), tid = (u64)omp_get_thread_num();
#else
    u64 nt = 1, tid = 0;
#endif
    u64 j0 = n * tid / nt, j1 = n * (tid + 1) / nt;
    std::vector<u128> s(acc + j0, acc + j1);
    for (u64 b = 0; b < batch; b++) {
      const u32* ctr = ct + b * n;
      const u32* ptr = pt + b * n;
      for (u64 j = j0; j < j1; j++) s[j - j0] += (u64)ctr[j] * ptr[j];
    }
    for (u64 j = j0; j < j1; j++) acc[j] = (u32)(s[j - j0] % p);
  }
}

// scalar-plaintext MAC (Z_q rings): acc[j] += sum_b ct[b][j] * w[b]
// — the reference's multiply_plain-by-constant accumulate
// (`seal_int/seal_ring.tcc:129-201`); same loop order as above.
void rn_ip_accumulate_scalar(const u32* ct, const u32* w, u32* acc, u64 batch,
                             u64 n, u32 p) {
#pragma omp parallel
  {
#ifdef _OPENMP
    u64 nt = (u64)omp_get_num_threads(), tid = (u64)omp_get_thread_num();
#else
    u64 nt = 1, tid = 0;
#endif
    u64 j0 = n * tid / nt, j1 = n * (tid + 1) / nt;
    std::vector<u128> s(acc + j0, acc + j1);
    for (u64 b = 0; b < batch; b++) {
      const u32* ctr = ct + b * n;
      u64 wb = w[b];
      for (u64 j = j0; j < j1; j++) s[j - j0] += (u64)ctr[j] * wb;
    }
    for (u64 j = j0; j < j1; j++) acc[j] = (u32)(s[j - j0] % p);
  }
}

// centered lift of values mod t into limb modulus Q (plaintext operand prep)
void rn_lift_rows(const u32* v, u32* out, u64 n, u32 t, u32 Q) {
#pragma omp parallel for schedule(static)
  for (u64 i = 0; i < n; i++) {
    u32 x = v[i];
    u64 y = x > (t >> 1) ? (u64)x + Q - t : (u64)x;
    if (y >= Q) y -= Q;
    out[i] = (u32)y;
  }
}

// ---- full groth16 witness map (prover mode), one outer limb ---------------
// Same algorithm as reductions/r1cs_to_qrp._witness_map_kernel with
// outputs="prover": COO scatter of the constraint evaluations, size-M
// inverse NTT interpolation over the roots domain, H = upper half of the
// size-2M NTT convolution of A and B (C's degree < M never reaches the
// quotient; d1=d2=d3=0 — groth16.tcc:76-84).  Bit-exact vs the JAX kernel
// when given the same roots w (order M) and w2 (order 2M).
// slot-batched over S independent slots (a dense ring element is S slot
// values; the Z_q case is S = 1).  z: [nvars+1][S]; coeffs: [nnz] (scalar,
// co_slots == 1, broadcast over slots) or [nnz][S]; outputs [M or M+1][S].
void rn_g16_witness_map(const int32_t* rowsA, const int32_t* colsA,
                        const u32* coA, u64 nnzA, u32 coA_slots,
                        const int32_t* rowsB, const int32_t* colsB,
                        const u32* coB, u64 nnzB, u32 coB_slots,
                        const u32* z, u32 S, u32 M, u32 p, u32 w, u32 w2,
                        u32* a_full, u32* b_full, u32* Hout) {
  NttTables t, t2;
  make_tables(t, p, M, w, 0);
  make_tables(t2, p, 2 * M, w2, 0);
  const u32 minv_sh = shoup_pre(t.minv, p);
  const u32 minv2_sh = shoup_pre(t2.minv, p);

#pragma omp parallel
  {
    std::vector<u32> ev(M), af(2 * M), bf(2 * M);
#pragma omp for schedule(static)
    for (u64 s = 0; s < S; s++) {
      // A-side: scatter evals, interpolate (inverse NTT; domain-order
      // evals carry the bit-reversed labeling)
      std::memset(ev.data(), 0, M * sizeof(u32));
      for (u64 k = 0; k < nnzA; k++) {
        u32 c = coA[coA_slots == 1 ? k : k * coA_slots + s];
        u32 v = (u32)((u64)c * z[(u64)colsA[k] * S + s] % p);
        ev[rowsA[k]] = addmod(ev[rowsA[k]], v, p);
      }
      dit_inverse(ev.data(), t);
      for (u32 i = 0; i < M; i++) {
        u32 c = shoup_mul(ev[i], t.minv, minv_sh, p);
        a_full[(u64)i * S + s] = c;
        af[i] = c;
      }
      std::memset(af.data() + M, 0, M * sizeof(u32));

      // B-side
      std::memset(ev.data(), 0, M * sizeof(u32));
      for (u64 k = 0; k < nnzB; k++) {
        u32 c = coB[coB_slots == 1 ? k : k * coB_slots + s];
        u32 v = (u32)((u64)c * z[(u64)colsB[k] * S + s] % p);
        ev[rowsB[k]] = addmod(ev[rowsB[k]], v, p);
      }
      dit_inverse(ev.data(), t);
      for (u32 i = 0; i < M; i++) {
        u32 c = shoup_mul(ev[i], t.minv, minv_sh, p);
        b_full[(u64)i * S + s] = c;
        bf[i] = c;
      }
      std::memset(bf.data() + M, 0, M * sizeof(u32));

      // H = coeffs(A*B)[M..2M-1] via size-2M cyclic NTTs
      dif_forward(af.data(), t2);
      dif_forward(bf.data(), t2);
      for (u64 i = 0; i < 2 * (u64)M; i++) af[i] = mulmod(af[i], bf[i], p);
      dit_inverse(af.data(), t2);
      for (u32 i = 0; i < M; i++)
        Hout[(u64)i * S + s] = shoup_mul(af[M + i], t2.minv, minv2_sh, p);
      Hout[(u64)M * S + s] = 0;  // + d1*d2*X^M with d = 0
    }
  }
}

}  // extern "C"
