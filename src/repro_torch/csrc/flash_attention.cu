// flash_attention: the rounded flash-attention family (the paper's
// stochastic rounding carried into the attention op).
//
// Replaces the TPU kernels of repro/kernels/flash_attention.py:
//   flash_fwd      <- flash_fwd_p      (K6, training forward)
//   flash_bwd_dq   <- flash_bwd_dq_p   (K7, dq; its first kernel stays
//                                        as flash_bwd_dq_simple)
//   flash_bwd_dkv  <- flash_bwd_dkv_p  (K7', per-query-head dk, dv; its
//                                        first kernel stays as
//                                        flash_bwd_dkv_simple)
//   flash_decode   <- flash_decode_p   (K9, one-token decode over a float
//                                        or packed KV cache; its first
//                                        kernel stays as flash_decode_tiled)
//   flash_decode_paged <- flash_decode_paged_p (K10, one-token decode over
//                                        a paged float or packed KV cache)
// Plain twins: repro_torch/kernels/flash_attention.py (*_plain).
//
// What each kernel must reproduce:
// * The reference's online softmax runs once per *logical* kv block
//   (kv_block keys): the block's row max before its exps, one P.V partial
//   product per block rounded on the av site with stream = block index.
//   A CUDA tile is smaller than a logical block, so the forward either
//   holds the block's logits in shared memory (fwd1_kernel) or makes two
//   passes over the block's tiles (fwd_kernel: row max of the rounded
//   logits, then p = exp(s - m_safe), its row sum and the unrounded P.V
//   partial), and rounds the partial once when the block is done.  The
//   backward kernels likewise sum a whole logical block's dq (or q
//   block's dk, dv) contribution before rounding it.
// * The same logits everywhere: qk_logit below is the one function that
//   computes q.k (fmaf in index order, times scale, rounded on the qk site
//   keyed by global (q position, k position), stream 0) in all four
//   kernels, so the backward recomputes bitwise the logits whose max and
//   sum the forward saved.
// * Masks in global positions (causal, window, ragged tails); masked
//   logits are -inf; m_safe, corr and linv guard non-finite values as the
//   reference does; rows of V past the valid length read as zero.
// A kv tile (forward) or q tile (backward) in which every pair is masked
// is skipped: with finite inputs it adds exact zeros.
//
// Arithmetic is IEEE float32 on the CUDA cores, expf (no fast math),
// __fmul_rn/__fadd_rn where the twin's order matters (no FMA contraction).
//
// What bounds them on an H100: at the training shape (B.H = 128, S = 256,
// d = 64) the forward does 2 S^2 d flops per head for QK^T and as many for
// P.V (half of them masked): operations, not bytes, bound it.  K6 runs
// fwd1_kernel, a single pass that holds a block's logits in shared memory
// (each computed, rounded and drawn once), tiles the products in registers
// from float4 shared loads, shares Threefry evaluations between four
// adjacent keys and stages K and V with cp.async; where a logical block's
// logits do not fit, the wrapper launches fwd_kernel's two passes
// (flash_fwd_two_pass).  The products stay on the CUDA cores in float32:
// TF32 or bf16 mma would change the logits that K7 and K7' recompute.
// fwd_kernel stages q, K and V tiles in shared memory and runs fp32 FMAs
// from there (two shared loads per FMA), computing each logit twice.  K9's
// first version ran fwd_kernel too, one block per (batch, kv head) for G =
// 8 query rows (16 blocks at the serve shape); it stays as
// flash_decode_tiled, the bitwise reference of the decode kernel below and
// K9's route for blocks whose logits that kernel cannot hold.
//
// The backward is bound the same way: per unmasked pair K7 does 3 d FMAs
// (the logit, dp = dO.v, ds.k) and K7' 4 d (the logit, dp, p.dO, ds.q),
// plus one qk draw.  The first versions (dq_kernel, dkv_kernel, kept as
// flash_bwd_dq_simple / flash_bwd_dkv_simple) ran each product as a scalar
// fmaf loop with two shared loads per FMA, one Threefry evaluation per
// pair and per rounded output, tiles staged by divisions and scalar loads,
// accumulators sized for d = 128 (an instance each for d = 256): the
// load/store unit, not the FMA pipe, bound them, at 16-21x their bound.
// dq_tile_kernel and dkv_tile_kernel (below) keep every sum in the first
// versions' order and tile it as fwd1_kernel does: 4 x 4 patches of pairs
// and 4-column output runs from float4 loads (eight shared loads per 64
// FMAs), draws shared by four keys or columns, 64-row blocks templated on
// d, K7's k and v tiles through a two-buffer cp.async ring, and K7's
// heaviest causal blocks (the last query rows) launched first.  At d = 256
// (gemma-7b's) a 64-row block's operands would not fit in shared memory:
// that instance takes 32-row blocks and tiles (201,088 and 139,648 B) and
// 1 x 4 patches of pairs (five shared loads per 16 FMAs).  Each tile still
// recomputes the logits and p that the other kernel also computes: one
// pass for both would change K7's interface (a ds scratch).
//
// Decode (K9 and K10) has a kernel of its own, decode_paged_kernel: one
// block per (request, kv head, query row), so the engine's 4 slots x 4
// kv heads x 8 rows fill 128 of the 132 SMs, and K9's serve shape (B.KV
// 16 x G 8) the same 128.  At that shape it moves a
// few KB and does ~1.3 MFLOP, so neither bytes nor operations bound it:
// the chain of dependent steps does (the page-table and K loads, a 64-long
// fmaf chain per logit, the page's max and sum, a 64-long fmaf chain per
// P.V output, the merge, each behind a barrier) and the launch.  Each
// logit is computed, rounded and drawn once; the pages' logits, exps and
// P.V chains run side by side; K rows come as 16-byte words straight into
// registers, V rows by cp.async while the logits compute.  Its order is
// fwd_kernel's: the logical block is one page, and each float operation
// (qk_logit's chain, the block max, m_safe and corr, the 64-key chunk
// sums with their pairing and butterfly, each output's P.V chain over the
// page's keys in order, the av rounding with stream = page, the merge,
// the division) runs on the same operands in the same order, so K10
// equals fwd_kernel with kv_block == page bit for bit.  K10's K/V rows
// are found through the request's block table (physical page p of kv head
// h is row p.KV + h of the (P.KV, page, d) pool); each request's length
// is read from device memory, so a serving step needs no host round trip.
// K9 runs the same kernel in contiguous mode (a template flag, so K10's
// instances are unchanged): row bh of the (B.KV, S_max, d) cache is read
// as pages of kv_block keys, key i of page j at row bh.S_max + j.page + i,
// with one length for every row, no table, and the last page cut at
// S_max where S_max % kv_block != 0, as fwd_kernel's last block is.  Draws
// keep the logical coordinates (column = logical position, av stream =
// logical page), so a result does not depend on where the pages lie.
// Pages past a request's length are never read: their close step (an
// idempotent one) is applied once.  Splitting one request's pages across
// blocks (flash-decoding) is not done: at a few pages a request the block
// holds them all.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "rounding.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTQ = 32;    // query rows per block (K6, K7, K9)
constexpr int kTK = 64;    // key rows per tile (K6, K7, K9)
constexpr int kTKV = 32;   // key rows per block (K7')
constexpr int kTQB = 32;   // query rows per tile (K7')
constexpr int kDMax = 256;      // head dims of every kernel (gemma-7b's)
constexpr int kDNarrow = 128;   // the head dims of the first instances
// outputs per thread of fwd_kernel and dq_kernel (kAcc) and of dkv_kernel
// (kAccKV): instances for d up to kDNarrow, and wide ones up to kDMax
constexpr int kAcc = kTQ * kDNarrow / kThreads;    // 16 outputs per thread
constexpr int kAccKV = kTKV * kDNarrow / kThreads;
constexpr int kAccWide = kTQ * kDMax / kThreads;
constexpr int kAccKVWide = kTKV * kDMax / kThreads;

struct Sites {
  rt::RoundParams p[3];
};

// Geometry of one call.  For decode, ``rows`` is G, every row's query
// position is length - 1, and the draws are keyed by the head row.
struct Geo {
  int rows;      // query rows per (batch, head): Sq, or G for decode
  int kv_rows;   // Skv, or S_max for decode
  int dk, dv;
  int n_heads, n_kv;
  int qb, kb;    // logical block sizes
  int q_offset;
  int causal, window;
  float scale;
  int decode;
  int length;    // decode: valid cache rows including the new token
};

__device__ __forceinline__ int kv_of(int bh, const Geo& g) {
  return bh / g.n_heads * g.n_kv + (bh % g.n_heads) / (g.n_heads / g.n_kv);
}

__device__ __forceinline__ int q_len(const Geo& g) {
  return g.decode ? g.length : g.q_offset + g.rows;
}

__device__ __forceinline__ int kv_len(const Geo& g) {
  return g.decode ? g.length : g.kv_rows;
}

// Query position of local query row r (the mask's coordinate).
__device__ __forceinline__ int qpos_of(int r, const Geo& g) {
  return g.decode ? g.length - 1 : g.q_offset + r;
}

// Draw row of local query row r: the global query position, or the head
// row of the group for decode.
__device__ __forceinline__ uint32_t drow_of(int r, const Geo& g) {
  return static_cast<uint32_t>(g.decode ? r : g.q_offset + r);
}

__device__ __forceinline__ bool valid(int qpos, int kpos, const Geo& g) {
  bool ok = qpos < q_len(g) && kpos < kv_len(g);
  if (g.causal) ok = ok && kpos <= qpos;
  if (g.window) ok = ok && kpos > qpos - g.window;
  return ok;
}

// One rounding site at global (row, col) on `stream`; w: the site's words.
__device__ __forceinline__ float round_site(float x, const rt::RoundParams& p,
                                            const uint32_t* w,
                                            uint32_t stream, uint32_t row,
                                            uint32_t col) {
  if (!p.enabled) return x;
  const uint32_t bits =
      p.mode != rt::kRN
          ? rt::element_bits(w[0], w[1], stream, p.rand_bits, row, col)
          : 0u;
  return rt::round_value(x, bits, p);
}

// The rounded logit of one (query, key) pair: every kernel calls this, so
// the forward and the backward's recompute agree bit for bit.
__device__ __forceinline__ float qk_logit(const float* q, const float* k,
                                          const Geo& g,
                                          const rt::RoundParams& p,
                                          const uint32_t* w, uint32_t row,
                                          uint32_t col) {
  float acc = 0.0f;
  for (int t = 0; t < g.dk; ++t) acc = fmaf(q[t], k[t], acc);
  return round_site(__fmul_rn(acc, g.scale), p, w, 0u, row, col);
}

__device__ __forceinline__ float dot(const float* a, const float* b, int n) {
  float acc = 0.0f;
  for (int t = 0; t < n; ++t) acc = fmaf(a[t], b[t], acc);
  return acc;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// K9's tiled route (flash_decode_tiled), and K6 where fwd1_kernel does not
// fit (two passes).
// ---------------------------------------------------------------------------
struct FwdArgs {
  const float* q;
  const void* k;
  const void* v;
  int code_bytes;          // 0: float32 cache; 1 or 2: packed code words
  rt::PackParams pack;
  const uint32_t* seeds;   // (rows of q, 6): [qk | av | out]
  float* out;
  float* m;                // forward only
  float* l;
  float* s_out;            // optional: the rounded masked logits
  Geo g;
  Sites sites;
};

__device__ __forceinline__ float load_kv(const void* base, size_t idx,
                                         int code_bytes,
                                         const rt::PackParams& pack) {
  if (code_bytes == 0) return static_cast<const float*>(base)[idx];
  const uint32_t c = code_bytes == 1
                         ? static_cast<const uint8_t*>(base)[idx]
                         : static_cast<const uint16_t*>(base)[idx];
  return rt::unpack(c, pack);
}

// kAccN outputs per thread: kAcc (d up to kDNarrow) or kAccWide (up to
// kDMax), two instances, so the first compiles as it did before the
// second existed.
template <int kAccN>
__global__ void __launch_bounds__(kThreads) fwd_kernel(FwdArgs a) {
  extern __shared__ float smem[];
  const int bh = blockIdx.y;
  const Geo& g = a.g;
  const int r0 = blockIdx.x * kTQ;
  const int nr = min(kTQ, g.rows - r0);
  const int kvrow = g.decode ? bh : kv_of(bh, g);
  const int ldk = g.dk + 1;
  float* Qs = smem;                    // kTQ x dk
  float* Ks = Qs + kTQ * g.dk;         // kTK x ldk
  float* Vs = Ks + kTK * ldk;          // kTK x dv
  float* Ss = Vs + kTK * g.dv;         // kTQ x kTK: logits, then p
  float* row_m = Ss + kTQ * kTK;
  float* row_l = row_m + kTQ;
  float* row_t = row_l + kTQ;          // block max, then block sum
  float* row_safe = row_t + kTQ;
  float* row_corr = row_safe + kTQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const uint32_t* w = a.seeds + static_cast<size_t>(bh) * 6;
  const rt::RoundParams& p_qk = a.sites.p[0];

  for (int e = tid; e < kTQ * g.dk; e += kThreads) {
    const int r = e / g.dk;
    Qs[e] = r < nr ? a.q[(static_cast<size_t>(bh) * g.rows + r0) * g.dk + e]
                   : 0.0f;
  }
  if (tid < kTQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.0f;
  }
  float acc[kAccN], pv[kAccN];
#pragma unroll
  for (int u = 0; u < kAccN; ++u) acc[u] = 0.0f;
  const int qpos_hi = qpos_of(r0 + nr - 1, g);
  const int n_k = (g.kv_rows + g.kb - 1) / g.kb;
  __syncthreads();

  for (int j = 0; j < n_k; ++j) {
    const int k0 = j * g.kb, k1 = min(k0 + g.kb, g.kv_rows);
    if (tid < kTQ) row_t[tid] = -INFINITY;
#pragma unroll
    for (int u = 0; u < kAccN; ++u) pv[u] = 0.0f;
    for (int pass = 0; pass < 2; ++pass) {
      for (int t0 = k0; t0 < k1; t0 += kTK) {
        if (t0 >= kv_len(g) || (g.causal && t0 > qpos_hi)) break;
        const int t1 = min(t0 + kTK, k1);
        const size_t row0 = static_cast<size_t>(kvrow) * g.kv_rows + t0;
        __syncthreads();
        for (int e = tid; e < kTK * g.dk; e += kThreads) {
          const int c = e / g.dk, t = e % g.dk;
          Ks[c * ldk + t] =
              t0 + c < t1 ? load_kv(a.k, (row0 + c) * g.dk + t,
                                    a.code_bytes, a.pack)
                          : 0.0f;
        }
        if (pass == 1) {
          const int v_end = min(t1, kv_len(g));
          for (int e = tid; e < kTK * g.dv; e += kThreads) {
            const int c = e / g.dv, t = e % g.dv;
            Vs[e] = t0 + c < v_end
                        ? load_kv(a.v, (row0 + c) * g.dv + t,
                                  a.code_bytes, a.pack)
                        : 0.0f;
          }
        }
        __syncthreads();
        for (int e = tid; e < kTQ * kTK; e += kThreads) {
          const int r = e / kTK, c = e % kTK, kpos = t0 + c;
          float s = -INFINITY;
          if (r < nr && kpos < t1) {
            if (valid(qpos_of(r0 + r, g), kpos, g))
              s = qk_logit(Qs + r * g.dk, Ks + c * ldk, g, p_qk, w,
                           drow_of(r0 + r, g), kpos);
            if (pass == 0 && a.s_out != nullptr)
              a.s_out[(static_cast<size_t>(bh) * g.rows + r0 + r) *
                          g.kv_rows + kpos] = s;
          }
          Ss[e] = pass == 0 ? s
                            : (isfinite(s) ? expf(__fsub_rn(s, row_safe[r]))
                                           : 0.0f);
        }
        __syncthreads();
        for (int r = warp; r < kTQ; r += kWarps) {
          const float x0 = Ss[r * kTK + lane], x1 = Ss[r * kTK + lane + 32];
          if (pass == 0) {
            const float mx = warp_max(fmaxf(x0, x1));
            if (lane == 0) row_t[r] = fmaxf(row_t[r], mx);
          } else {
            const float sm = warp_sum(__fadd_rn(x0, x1));
            if (lane == 0) row_t[r] = __fadd_rn(row_t[r], sm);
          }
        }
        if (pass == 1) {
#pragma unroll
          for (int u = 0; u < kAccN; ++u) {
            const int e = tid + kThreads * u;
            if (e < kTQ * g.dv) {
              const int r = e / g.dv, c = e % g.dv;
              float x = pv[u];
              for (int kk = 0; kk < t1 - t0; ++kk)
                x = fmaf(Ss[r * kTK + kk], Vs[kk * g.dv + c], x);
              pv[u] = x;
            }
          }
        }
      }
      __syncthreads();
      if (pass == 0 && tid < kTQ) {
        // the block's max is known: m_new, m_safe and corr of each row
        const float m_old = row_m[tid];
        const float m_new = fmaxf(m_old, row_t[tid]);
        const float safe = isfinite(m_new) ? m_new : 0.0f;
        row_safe[tid] = safe;
        row_corr[tid] = isfinite(m_old) ? expf(__fsub_rn(m_old, safe)) : 0.0f;
        row_m[tid] = m_new;
        row_t[tid] = 0.0f;
      }
      __syncthreads();
    }
    // close the logical block: round its P.V partial once (av site, stream
    // j), rescale the running sums
#pragma unroll
    for (int u = 0; u < kAccN; ++u) {
      const int e = tid + kThreads * u;
      if (e < kTQ * g.dv) {
        const int r = e / g.dv, c = e % g.dv;
        const float pr = round_site(pv[u], a.sites.p[1], w + 2,
                                    static_cast<uint32_t>(j),
                                    drow_of(r0 + r, g), c);
        acc[u] = __fadd_rn(__fmul_rn(acc[u], row_corr[r]), pr);
      }
    }
    __syncthreads();
    if (tid < kTQ)
      row_l[tid] = __fadd_rn(__fmul_rn(row_l[tid], row_corr[tid]), row_t[tid]);
    __syncthreads();
  }

#pragma unroll
  for (int u = 0; u < kAccN; ++u) {
    const int e = tid + kThreads * u;
    if (e < kTQ * g.dv) {
      const int r = e / g.dv, c = e % g.dv;
      if (r < nr) {
        const float o = __fdiv_rn(acc[u], fmaxf(row_l[r], 1e-30f));
        a.out[(static_cast<size_t>(bh) * g.rows + r0 + r) * g.dv + c] =
            round_site(o, a.sites.p[2], w + 4, 0u, drow_of(r0 + r, g), c);
      }
    }
  }
  if (!g.decode && tid < nr) {
    a.m[static_cast<size_t>(bh) * g.rows + r0 + tid] = row_m[tid];
    a.l[static_cast<size_t>(bh) * g.rows + r0 + tid] = row_l[tid];
  }
}

// ---------------------------------------------------------------------------
// K6: the single-pass training forward.
// ---------------------------------------------------------------------------
// A block takes 32 query rows of one head and, per logical kv block, holds
// their logits over the keys fwd_kernel visits (its 64-key tiles up to the
// causal edge) in shared memory: each logit is computed, rounded and drawn
// once, and the row max, the exps, the row sums and P.V read them there.
// Every value is the one fwd_kernel computes, in the same order: a logit
// is qk_logit's fmaf chain over t = 0..d-1, each row sum runs over the same
// 64-key chunks with the same pairing and butterfly, and each P.V output
// sums its keys in order.  So out, m, l and the logits equal fwd_kernel's
// bit for bit, and K7 / K7' recompute the same logits.
//
// Logits: thread (warp w, lane x) owns rows 4w..4w+3 and keys 4x..4x+3 of
// a 128-key tile, reads q and k as float4 (k rows swizzled by 16-byte
// chunk so the eight lanes of a quarter-warp hit distinct banks), and
// draws its four keys' fields from one or two Threefry evaluations
// (element_bits4).  At d = 256 a tile holds 64 keys (the two tiles of
// 128 would take 256 KB): lane x owns keys 4 (x % 16).. and rows 4w + 2 (x
// / 16).., two of them.  P.V: a thread owns 4 consecutive output columns
// of kFRows rows.  K and V tiles are staged with cp.async into two
// buffers, the next tile loading while the current one computes.
constexpr int kSmemMax = 232448;   // the H100's shared memory per block

// keys per staged tile
__host__ __device__ constexpr int fwd1_tile_keys(int d) {
  return d > 128 ? 64 : 128;
}

template <int D>
struct FwdShape {
  static constexpr int kChunks = D / 4;   // 16-byte chunks per key row
  static constexpr int kSwizzle = (kChunks < 8 ? kChunks : 8) - 1;
  static constexpr int kRowGroups = 256 / kChunks < kTQ ? 256 / kChunks : kTQ;
  static constexpr int kRows = kTQ / kRowGroups;   // P.V rows per thread
  static constexpr int kTileKeys = fwd1_tile_keys(D);
  // the logits: lanes per row (4 keys each), rows per thread
  static constexpr int kKeyLanes = kTileKeys / 4;
  static constexpr int kLRows = 4 * kKeyLanes / 32;
};

// Row stride of the logits: the largest logical block, in whole tiles, and
// 4 more floats so P.V's row pairs fall in different banks.
__host__ __device__ inline int logits_stride(int kb, int d) {
  const int tk = fwd1_tile_keys(d);
  return (kb + tk - 1) / tk * tk + 4;
}

size_t fwd1_smem(int kb, int d) {
  return sizeof(float) *
         (static_cast<size_t>(kTQ) * d + 2 * fwd1_tile_keys(d) * d +
          static_cast<size_t>(kTQ) * logits_stride(kb, d) + 4 * kTQ);
}

// element_bits at columns c0..c0+3, shared evaluations where c0 % 4 == 0.
__device__ __forceinline__ void site_bits4(const rt::RoundParams& p,
                                           const uint32_t* w,
                                           uint32_t stream, uint32_t row,
                                           uint32_t c0, uint32_t (&b)[4]) {
  if (!p.enabled || p.mode == rt::kRN) {
    b[0] = b[1] = b[2] = b[3] = 0u;
  } else if ((c0 & 3u) == 0u) {
    rt::element_bits4(w[0], w[1], stream, p.rand_bits, row, c0, b);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = rt::element_bits(w[0], w[1], stream, p.rand_bits, row, c0 + j);
  }
}

__device__ __forceinline__ float round_bits(float x,
                                            const rt::RoundParams& p,
                                            uint32_t bits) {
  return p.enabled ? rt::round_value(x, bits, p) : x;
}

// Rows [0, n) of a (rows, D) float32 array into rows [0, n) of a stage
// buffer, 16 bytes per cp.async (not committed); K rows swizzled (chunk ^
// (row / 4)).
template <int D, bool kSwizzled>
__device__ __forceinline__ void copy_rows(float* buf, const float* src,
                                          int n) {
  using S = FwdShape<D>;
  for (int e = threadIdx.x; e < n * S::kChunks; e += kThreads) {
    const int c = e / S::kChunks, ch = e % S::kChunks;
    const int pch = kSwizzled ? ch ^ ((c >> 2) & S::kSwizzle) : ch;
    __pipeline_memcpy_async(buf + c * D + 4 * pch,
                            src + static_cast<size_t>(c) * D + 4 * ch, 16);
  }
}

// Rows [key0, key0 + n) into a kTileKeys x D stage buffer, one commit
// group.
template <int D, bool kSwizzled>
__device__ __forceinline__ void stage_tile(float* buf, const float* src,
                                           int key0, int n) {
  copy_rows<D, kSwizzled>(buf, src + static_cast<size_t>(key0) * D, n);
  __pipeline_commit();
}

template <int D>
__global__ void __launch_bounds__(kThreads) fwd1_kernel(FwdArgs a) {
  using S = FwdShape<D>;
  constexpr int TK = S::kTileKeys;
  extern __shared__ float smem[];
  const Geo& g = a.g;
  const int bh = blockIdx.y;
  const int r0 = blockIdx.x * kTQ;
  const int nr = min(kTQ, g.rows - r0);
  const int lds = logits_stride(g.kb, D);
  float* Qs = smem;                    // kTQ x D
  float* Bs = Qs + kTQ * D;            // 2 x (TK x D): K, then V tiles
  float* Ss = Bs + 2 * TK * D;         // kTQ x lds: logits, then p
  float* row_m = Ss + kTQ * lds;
  float* row_l = row_m + kTQ;
  float* row_corr = row_l + kTQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the logits' keys 4 kg.. and rows lr0..lr0 + kLRows - 1
  const int kg = S::kKeyLanes == 32 ? lane : lane % S::kKeyLanes;
  const int lr0 = 4 * warp + (S::kKeyLanes == 32 ? 0 : lane / S::kKeyLanes) *
                                 S::kLRows;
  const uint32_t* w = a.seeds + static_cast<size_t>(bh) * 6;
  const rt::RoundParams& p_qk = a.sites.p[0];
  const float* kbase = static_cast<const float*>(a.k) +
                       static_cast<size_t>(kv_of(bh, g)) * g.kv_rows * D;
  const float* vbase = static_cast<const float*>(a.v) +
                       static_cast<size_t>(kv_of(bh, g)) * g.kv_rows * D;

  for (int e = tid; e < kTQ * D; e += kThreads)
    Qs[e] = e / D < nr ? a.q[(static_cast<size_t>(bh) * g.rows + r0) * D + e]
                       : 0.0f;
  if (tid < kTQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.0f;
  }
  // P.V's outputs: columns 4 pc.. of rows pr * kRows..
  const int pc = tid % S::kChunks, pr = tid / S::kChunks;
  const bool pv_thread = pr < S::kRowGroups;
  float acc[S::kRows][4];
#pragma unroll
  for (int i = 0; i < S::kRows; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  const int qpos_hi = g.q_offset + r0 + nr - 1;
  const int n_k = (g.kv_rows + g.kb - 1) / g.kb;
  __syncthreads();

  for (int j = 0; j < n_k; ++j) {
    const int k0 = j * g.kb, k1 = min(k0 + g.kb, g.kv_rows);
    // the keys of fwd_kernel's 64-key tiles up to the causal edge
    int nkeys = k1 - k0;
    if (g.causal)
      nkeys = k0 > qpos_hi ? 0 : min(nkeys, ((qpos_hi - k0) / kTK + 1) * kTK);
    const int ntiles = (nkeys + TK - 1) / TK;

    // logits, rounded once, into Ss
    if (ntiles > 0) stage_tile<D, true>(Bs, kbase, k0, min(TK, nkeys));
    for (int i = 0; i < ntiles; ++i) {
      if (i + 1 < ntiles) {
        stage_tile<D, true>(Bs + ((i + 1) & 1) * TK * D, kbase,
                            k0 + (i + 1) * TK,
                            min(TK, nkeys - (i + 1) * TK));
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();
      const float* Kt = Bs + (i & 1) * TK * D;
      float s[S::kLRows][4];
#pragma unroll
      for (int r = 0; r < S::kLRows; ++r)
        s[r][0] = s[r][1] = s[r][2] = s[r][3] = 0.0f;
#pragma unroll 4
      for (int t = 0; t < D; t += 4) {
        float4 qf[S::kLRows], kf[4];
#pragma unroll
        for (int r = 0; r < S::kLRows; ++r)
          qf[r] = *reinterpret_cast<const float4*>(Qs + (lr0 + r) * D + t);
        const int pch = (t / 4) ^ (kg & S::kSwizzle);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          kf[c] = *reinterpret_cast<const float4*>(Kt + (4 * kg + c) * D +
                                                   4 * pch);
#pragma unroll
        for (int r = 0; r < S::kLRows; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[r][c] = fmaf(qf[r].x, kf[c].x, s[r][c]);
            s[r][c] = fmaf(qf[r].y, kf[c].y, s[r][c]);
            s[r][c] = fmaf(qf[r].z, kf[c].z, s[r][c]);
            s[r][c] = fmaf(qf[r].w, kf[c].w, s[r][c]);
          }
      }
      const int loc = i * TK + 4 * kg;   // column in Ss
      const int kpos0 = k0 + loc;
#pragma unroll
      for (int r = 0; r < S::kLRows; ++r) {
        const int rr = lr0 + r;
        const int qpos = g.q_offset + r0 + rr;
        uint32_t bits[4];
        site_bits4(p_qk, w, 0u, static_cast<uint32_t>(qpos),
                   static_cast<uint32_t>(kpos0), bits);
        float sv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          sv[c] = -INFINITY;
          if (rr < nr && loc + c < nkeys && valid(qpos, kpos0 + c, g))
            sv[c] = round_bits(__fmul_rn(s[r][c], g.scale), p_qk, bits[c]);
          if (a.s_out != nullptr && rr < nr && loc + c < nkeys)
            a.s_out[(static_cast<size_t>(bh) * g.rows + r0 + rr) *
                        g.kv_rows + kpos0 + c] = sv[c];
        }
        *reinterpret_cast<float4*>(Ss + rr * lds + loc) =
            make_float4(sv[0], sv[1], sv[2], sv[3]);
      }
      __syncthreads();
    }

    // V's first tile loads while each warp reduces its rows: the block's
    // max, m_new, m_safe and corr, then p = exp(s - m_safe) in place and
    // the row sum in fwd_kernel's order (64-key chunks, lanes c and c + 32
    // paired, then the butterfly)
    if (ntiles > 0) stage_tile<D, false>(Bs, vbase, k0, min(TK, nkeys));
    for (int r = warp; r < kTQ; r += kWarps) {
      float* row = Ss + r * lds;
      float mx = -INFINITY;
      for (int c = lane; c < nkeys; c += 32) mx = fmaxf(mx, row[c]);
      mx = warp_max(mx);
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);
      const float safe = isfinite(m_new) ? m_new : 0.0f;
      const float corr = isfinite(m_old) ? expf(__fsub_rn(m_old, safe)) : 0.0f;
      float sum = 0.0f;
      for (int c0 = 0; c0 < nkeys; c0 += kTK) {
        float p[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + 32 * h + lane;
          const float x = c < nkeys ? row[c] : -INFINITY;
          p[h] = isfinite(x) ? expf(__fsub_rn(x, safe)) : 0.0f;
          if (c < nkeys) row[c] = p[h];
        }
        sum = __fadd_rn(sum, warp_sum(__fadd_rn(p[0], p[1])));
      }
      __syncwarp();
      if (lane == 0) {
        row_m[r] = m_new;
        row_corr[r] = corr;
        row_l[r] = __fadd_rn(__fmul_rn(row_l[r], corr), sum);
      }
    }

    // P.V over the same keys, in order
    float pv[S::kRows][4];
#pragma unroll
    for (int i = 0; i < S::kRows; ++i)
      pv[i][0] = pv[i][1] = pv[i][2] = pv[i][3] = 0.0f;
    for (int i = 0; i < ntiles; ++i) {
      if (i + 1 < ntiles) {
        stage_tile<D, false>(Bs + ((i + 1) & 1) * TK * D, vbase,
                             k0 + (i + 1) * TK,
                             min(TK, nkeys - (i + 1) * TK));
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();
      const float* Vt = Bs + (i & 1) * TK * D;
      const int tl = min(TK, nkeys - i * TK);
      if (pv_thread) {
        const float* prow = Ss + pr * S::kRows * lds + i * TK;
        int kk = 0;
        for (; kk + 4 <= tl; kk += 4) {
          float4 pf[S::kRows], vf[4];
#pragma unroll
          for (int r = 0; r < S::kRows; ++r)
            pf[r] = *reinterpret_cast<const float4*>(prow + r * lds + kk);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            vf[u] = *reinterpret_cast<const float4*>(Vt + (kk + u) * D +
                                                     4 * pc);
#pragma unroll
          for (int r = 0; r < S::kRows; ++r) {
            const float pu[4] = {pf[r].x, pf[r].y, pf[r].z, pf[r].w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              pv[r][0] = fmaf(pu[u], vf[u].x, pv[r][0]);
              pv[r][1] = fmaf(pu[u], vf[u].y, pv[r][1]);
              pv[r][2] = fmaf(pu[u], vf[u].z, pv[r][2]);
              pv[r][3] = fmaf(pu[u], vf[u].w, pv[r][3]);
            }
          }
        }
        for (; kk < tl; ++kk) {
          const float4 vf = *reinterpret_cast<const float4*>(Vt + kk * D +
                                                             4 * pc);
#pragma unroll
          for (int r = 0; r < S::kRows; ++r) {
            const float pu = prow[r * lds + kk];
            pv[r][0] = fmaf(pu, vf.x, pv[r][0]);
            pv[r][1] = fmaf(pu, vf.y, pv[r][1]);
            pv[r][2] = fmaf(pu, vf.z, pv[r][2]);
            pv[r][3] = fmaf(pu, vf.w, pv[r][3]);
          }
        }
      }
      __syncthreads();
    }
    if (ntiles == 0) __syncthreads();   // the row statistics are written

    // close the logical block: round its P.V partial once (av site, stream
    // j), rescale the running sums
    if (pv_thread) {
#pragma unroll
      for (int r = 0; r < S::kRows; ++r) {
        const int rr = pr * S::kRows + r;
        const uint32_t drow = static_cast<uint32_t>(g.q_offset + r0 + rr);
        uint32_t bits[4];
        site_bits4(a.sites.p[1], w + 2, static_cast<uint32_t>(j), drow,
                   static_cast<uint32_t>(4 * pc), bits);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[r][c] = __fadd_rn(__fmul_rn(acc[r][c], row_corr[rr]),
                                round_bits(pv[r][c], a.sites.p[1], bits[c]));
      }
    }
    __syncthreads();
  }

  if (pv_thread) {
#pragma unroll
    for (int r = 0; r < S::kRows; ++r) {
      const int rr = pr * S::kRows + r;
      if (rr >= nr) continue;
      const uint32_t drow = static_cast<uint32_t>(g.q_offset + r0 + rr);
      uint32_t bits[4];
      site_bits4(a.sites.p[2], w + 4, 0u, drow,
                 static_cast<uint32_t>(4 * pc), bits);
      float o[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        o[c] = round_bits(__fdiv_rn(acc[r][c], fmaxf(row_l[rr], 1e-30f)),
                          a.sites.p[2], bits[c]);
      *reinterpret_cast<float4*>(
          a.out + (static_cast<size_t>(bh) * g.rows + r0 + rr) * D + 4 * pc) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
  }
  if (tid < nr) {
    a.m[static_cast<size_t>(bh) * g.rows + r0 + tid] = row_m[tid];
    a.l[static_cast<size_t>(bh) * g.rows + r0 + tid] = row_l[tid];
  }
}

// ---------------------------------------------------------------------------
// K10 and K9: the decode kernel (a paged pool, or a contiguous cache).
// ---------------------------------------------------------------------------
// One block of kDecThreads per (request, kv head, query row): the engine's
// 4 slots x 4 kv heads x G = 8 rows make 128 blocks on the 132 SMs.  A
// round takes whole logical blocks (pages) of the request, up to kDecKeys
// keys, and holds their logits in shared memory, each computed, rounded
// and drawn once by the thread of its key; then, in fwd_kernel's order,
// each page's max, the exps against the running max, each page's sum (its
// 64-key chunks, key c paired with c + 32, then warp_sum's butterfly),
// each page's P.V partial (one fmaf chain per output column over the
// page's keys in order, rounded once on the av site with stream = page)
// and the page-by-page merge of m, l and acc.  A page's keys are the ones
// fwd_kernel visits: its 64-key tiles that start below the length, the
// masked ones as -inf logits and zero exps, V rows at or past the length
// as zeros, so every value equals fwd_kernel's bit for bit (K10 equals
// flash_decode_tiled with kv_block == page, and K9 equals it always).  The pages' P.V chains, exps and logits run
// in parallel where fwd_kernel runs them one tile after another.  A page
// longer than kDecKeys is one round whose V rows are staged in pieces.
//
// On the card the block has one warp per scheduler, so every dependent
// step shows: the block index splits without divisions (a 3-D grid), the
// draws use shifts, 1-byte codes decode without branches (dec8), and the
// head dim is known at compile time where dk == dv is 16, 32, 64, 128 or
// 256 and rows are 16-byte aligned: K rows then come as 16-byte words
// straight into registers, all loads issued before the chain (64 words at
// most at a time: a float32 row of 256 in four batches), and V rows by
// cp.async while the logits compute.  P.V reads sixteen keys' V values
// ahead of their FMAs.  A thread owns output columns tid and, where dv
// exceeds the block's 128 threads (d = 256, and the generic instance),
// tid + 128.
constexpr int kDecThreads = 128;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecKeys = 128;    // keys per round, V rows per piece
constexpr int kDecPages = 32;    // pages per round at most

// How the cache holds K and V: float32 values, 1-byte code words decoded
// by dec8 (without or with a non-finite field), or code words of any width
// through rt::unpack.
enum CodeKind : int { kF32 = 0, kByte = 1, kByteNF = 2, kCode = 3 };

struct DecodeArgs {
  const float* q;
  const void* k;
  const void* v;
  int code_bytes;          // 0: float32 cache
  rt::PackParams pack;
  // dec8: the code's sign to bit 31, its field and mantissa to a float32's
  // exponent and mantissa, the field of +-inf / NaN, 2^(126 + emin)
  int sign_shift;
  uint32_t mag_mask;
  int mag_shift;
  uint32_t nf_field;
  float rebase;
  const uint32_t* seeds;   // (B.KV, 6): [qk | av | out]
  const int* lengths;      // (B,)
  const int* tables;       // (B, n_max): logical -> physical page
  float* out;
  int G, n_kv, n_max, page, page_shift, dk, dv, window;   // page_shift:
  float scale;                                            // -1 unless 2^k
  Sites sites;
  // contiguous mode (K9): rows of the (B.KV, stride, d) cache per B.KV
  // row, and the length every row shares (no tables, no lengths)
  int stride;
  int length;
};

// A 1-byte code word as float32, bit for bit rt::unpack.  Sign, field and
// mantissa placed in a float32's sign, exponent and mantissa give
// 2^(field - 127) (1 + m 2^-mbits), or for field 0 the subnormal
// m 2^(-126 - mbits); one multiply by 2^(126 + emin) rebases both onto the
// grid, exactly where emin lies in [-120, 1] (the host's condition).  Bits
// of c above the code's sign are ignored.
template <bool kNF>
__device__ __forceinline__ float dec8(uint32_t c, const DecodeArgs& a) {
  const uint32_t body = (c & a.mag_mask) << a.mag_shift;
  const uint32_t sign = (c << a.sign_shift) & 0x80000000u;
  const float f = __fmul_rn(__uint_as_float(sign | body), a.rebase);
  if (!kNF) return f;
  const uint32_t nf = (body & 0x7FFFFFu) ? 0x7FC00000u : sign | 0x7F800000u;
  return (body >> 23) == a.nf_field ? __uint_as_float(nf) : f;
}

template <int kKind>
__device__ __forceinline__ float code_at(const void* base, size_t i,
                                         const DecodeArgs& a) {
  if constexpr (kKind == kF32) {
    return static_cast<const float*>(base)[i];
  } else if constexpr (kKind == kCode) {
    const uint32_t c = a.code_bytes == 1
                           ? static_cast<const uint8_t*>(base)[i]
                           : static_cast<const uint16_t*>(base)[i];
    return rt::unpack(c, a.pack);
  } else {
    return dec8<kKind == kByteNF>(static_cast<const uint8_t*>(base)[i], a);
  }
}

// rt::element_bits for the draw widths the kernels take (32, 16, 8), its
// divisions by 32 / rand_bits done as shifts.
__device__ __forceinline__ uint32_t draw_bits(const rt::RoundParams& p,
                                              const uint32_t* w,
                                              uint32_t stream, uint32_t row,
                                              uint32_t col) {
  if (!p.enabled || p.mode == rt::kRN) return 0u;
  const int lg = p.rand_bits == 32 ? 0 : (p.rand_bits == 16 ? 1 : 2);
  const uint32_t wc = col >> lg;
  uint32_t o0, o1;
  rt::threefry2x32(w[0], w[1] + rt::kGolden * stream, row, wc >> 1, o0, o1);
  const uint32_t word = (wc & 1u) ? o1 : o0;
  if (lg == 0) return word;
  return (word >> ((col & ((1u << lg) - 1u)) * p.rand_bits)) &
         ((1u << p.rand_bits) - 1u);
}

__device__ __forceinline__ int page_of(int i, const DecodeArgs& a) {
  return a.page_shift >= 0 ? i >> a.page_shift : i / a.page;
}

// qk_logit's fmaf chain (t = 0..dk-1) of q against key row `row` of the
// pool.  DK > 0: rows of DK elements on 16-byte boundaries, read as
// 16-byte words, all loads issued before the chain.
template <int kKind, int DK>
__device__ __forceinline__ float decode_dot(const float* Qs, size_t row,
                                            const DecodeArgs& a) {
  float acc = 0.0f;
  if constexpr (DK > 0 && kKind != kCode) {
    constexpr int kPer = kKind == kF32 ? 4 : 16;   // elements per word
    constexpr int kWords = DK / kPer;
    // words loaded ahead of their FMAs: all of a row up to 32, else 16
    constexpr int kBatch = kWords > 32 ? 16 : kWords;
    const uint4* src = reinterpret_cast<const uint4*>(a.k) + row * kWords;
#pragma unroll
    for (int i0 = 0; i0 < kWords; i0 += kBatch) {
      uint4 w[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) w[i] = __ldg(src + i0 + i);
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const uint32_t u[4] = {w[i].x, w[i].y, w[i].z, w[i].w};
#pragma unroll
        for (int g4 = 0; g4 < kPer / 4; ++g4) {
          const float4 q4 = reinterpret_cast<const float4*>(
              Qs)[((i0 + i) * kPer) / 4 + g4];
          const float qv[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float kv;
            if constexpr (kKind == kF32)
              kv = __uint_as_float(u[e]);
            else
              kv = dec8<kKind == kByteNF>(u[g4] >> (8 * e), a);
            acc = fmaf(qv[e], kv, acc);
          }
        }
      }
    }
  } else {
    const int dk = DK > 0 ? DK : a.dk;
    for (int t = 0; t < dk; ++t)
      acc = fmaf(Qs[t], code_at<kKind>(a.k, row * dk + t, a), acc);
  }
  return acc;
}

// The pool row of key i of a round that starts at logical page j0; in
// contiguous mode h is the B.KV row and the row follows from the stride.
template <bool kContig>
__device__ __forceinline__ size_t page_row(const DecodeArgs& a,
                                           const int* table, int h, int j0,
                                           int i) {
  if constexpr (kContig) {
    return static_cast<size_t>(h) * a.stride +
           static_cast<size_t>(j0) * a.page + i;
  } else {
    const int b = page_of(i, a);
    return (static_cast<size_t>(table[j0 + b]) * a.n_kv + h) * a.page +
           (i - b * a.page);
  }
}

// V rows of round keys [i0, i1) into Vs (row i - i0), raw; rows at or past
// the length are not read (P.V takes them as zeros).  DK > 0: 16-byte
// cp.async; else byte copies (made before the next barrier).
template <int kKind, int DK, bool kContig>
__device__ __forceinline__ void stage_v(char* Vs, const DecodeArgs& a,
                                        const int* table, int h, int j0,
                                        int i0, int i1, int length,
                                        int vrow) {
  const char* src = static_cast<const char*>(a.v);
  const int k0 = j0 * a.page;
  if constexpr (DK > 0 && kKind != kCode) {
    constexpr int kChunks = DK * (kKind == kF32 ? 4 : 1) / 16;
    for (int e = threadIdx.x; e < (i1 - i0) * kChunks; e += kDecThreads) {
      const int i = i0 + e / kChunks, ch = e % kChunks;
      if (k0 + i < length)
        __pipeline_memcpy_async(
            Vs + static_cast<size_t>(i - i0) * vrow + 16 * ch,
            src + page_row<kContig>(a, table, h, j0, i) * vrow + 16 * ch,
            16);
    }
    __pipeline_commit();
  } else {
    for (int e = threadIdx.x; e < (i1 - i0) * vrow; e += kDecThreads) {
      const int i = i0 + e / vrow, by = e % vrow;
      if (k0 + i < length)
        Vs[static_cast<size_t>(i - i0) * vrow + by] =
            src[page_row<kContig>(a, table, h, j0, i) * vrow + by];
    }
  }
}

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Shared memory of one block: staged V rows, q, a round's logits, the
// pages' maxima and sums, their rounded P.V partials, the request's
// block table (n_max 0 in contiguous mode).
size_t decode_smem(int page, int dk, int dv, int elt_bytes, int n_max) {
  return round_up(kDecKeys * dv * elt_bytes, 16) +
         sizeof(float) * (round_up(dk, 4) + (page > kDecKeys ? page : kDecKeys) +
                          2 * kDecPages + kDecPages * dv + n_max);
}

// One P.V output's fmaf chain over round keys [i0, i1) in order, V from
// Vs (row i - v0), keys at or past kv_end as zeros; sixteen keys' loads
// ahead of their FMAs (rows past kv_end are read and not used).
template <int kKind, int DV>
__device__ __forceinline__ float pv_chain(float x, const float* S,
                                          const char* Vs, int v0, int i0,
                                          int i1, int c, int kv_end,
                                          const DecodeArgs& a) {
  const int dv = DV > 0 ? DV : a.dv;
  int i = i0;
  for (; i + 16 <= i1; i += 16) {
    float p16[16], v16[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      p16[u] = S[i + u];
      v16[u] = code_at<kKind>(Vs, static_cast<size_t>(i + u - v0) * dv + c,
                              a);
    }
#pragma unroll
    for (int u = 0; u < 16; ++u)
      x = fmaf(p16[u], i + u < kv_end ? v16[u] : 0.0f, x);
  }
  for (; i < i1; ++i) {
    const float vv =
        code_at<kKind>(Vs, static_cast<size_t>(i - v0) * dv + c, a);
    x = fmaf(S[i], i < kv_end ? vv : 0.0f, x);
  }
  return x;
}

template <int kKind, int DK, bool kContig>
__global__ void __launch_bounds__(kDecThreads)
decode_paged_kernel(DecodeArgs a) {
  extern __shared__ float smem[];
  constexpr int kElt = kKind == kF32 ? 4 : 1;
  const int elt = kKind == kCode ? a.code_bytes : kElt;
  const int dk = DK > 0 ? DK : a.dk, dv = DK > 0 ? DK : a.dv;
  // output columns per thread: tid + kDecThreads u, u < kCols
  constexpr int kCols = DK > kDecThreads ? DK / kDecThreads
                        : DK > 0        ? 1
                                        : kDMax / kDecThreads;
  const int page = a.page;
  const int r = blockIdx.x, h = blockIdx.y, req = blockIdx.z;
  const int bh = req * a.n_kv + h;
  const int hrow = kContig ? bh : h;    // page_row's head argument
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int vrow = dv * elt;
  char* Vs = reinterpret_cast<char*>(smem);
  float* Qs = reinterpret_cast<float*>(Vs + round_up(kDecKeys * vrow, 16));
  float* S = Qs + round_up(dk, 4);                 // logits, then p
  float* bmax = S + (page > kDecKeys ? page : kDecKeys);
  float* bsum = bmax + kDecPages;
  float* PR = bsum + kDecPages;                    // kDecPages x dv
  int* table = reinterpret_cast<int*>(PR + kDecPages * dv);   // n_max
  const uint32_t* w = a.seeds + static_cast<size_t>(bh) * 6;
  const rt::RoundParams &p_qk = a.sites.p[0], &p_av = a.sites.p[1],
                        &p_out = a.sites.p[2];
  // this thread's first P.V output of a round: page b0, column c0
  const int b0 = tid / dv, c0 = tid - b0 * dv;
  // the request's length, block table and query row, all loads at once;
  // the draws of the first round's first key and output and of the
  // output column meanwhile
  const int length = kContig ? a.length : a.lengths[req];
  if constexpr (!kContig)
    for (int t = tid; t < a.n_max; t += kDecThreads)
      table[t] = a.tables[static_cast<size_t>(req) * a.n_max + t];
  for (int t = tid; t < dk; t += kDecThreads)
    Qs[t] = a.q[(static_cast<size_t>(bh) * a.G + r) * dk + t];
  uint32_t qk_bits = draw_bits(p_qk, w, 0u, r, tid);
  uint32_t av_bits = draw_bits(p_av, w + 2, b0, r, c0);
  uint32_t out_bits[kCols];
#pragma unroll
  for (int u = 0; u < kCols; ++u)
    out_bits[u] = draw_bits(p_out, w + 4, 0u, r, tid + kDecThreads * u);
  // pages that fwd_kernel visits: those starting below the length
  const int n_vis = length > 0 ? min((length - 1) / page + 1, a.n_max) : 0;
  const int per_round = page >= kDecKeys ? 1 : min(kDecKeys / page, kDecPages);
  float m = -INFINITY, l = 0.0f, acc[kCols];   // acc: column tid + 128 u
#pragma unroll
  for (int u = 0; u < kCols; ++u) acc[u] = 0.0f;
  __syncthreads();

  for (int j0 = 0; j0 < n_vis; j0 += per_round) {
    const int np = min(per_round, n_vis - j0);
    // the last page's keys: its 64-key tiles that start below the length
    const int last = (j0 + np - 1) * page;
    int nkeys = (np - 1) * page + min(page, round_up(length - last, kTK));
    // a contiguous cache's last block ends at S_max, as fwd_kernel's does
    if constexpr (kContig) nkeys = min(nkeys, a.stride - j0 * page);
    const int kv_end = length - j0 * page;     // round keys with a V row
    stage_v<kKind, DK, kContig>(Vs, a, table, hrow, j0, 0,
                                min(nkeys, kDecKeys), length, vrow);
    // the logits, each computed, rounded and drawn once (qk site, keyed
    // by head row and logical position, stream 0); masked ones -inf
    for (int i = tid; i < nkeys; i += kDecThreads) {
      const int kpos = j0 * page + i;
      float s = -INFINITY;
      if (kpos < length && (a.window == 0 || kpos > length - 1 - a.window)) {
        const uint32_t bits =
            i == tid ? qk_bits : draw_bits(p_qk, w, 0u, r, kpos);
        s = round_bits(
            __fmul_rn(decode_dot<kKind, DK>(
                          Qs, page_row<kContig>(a, table, hrow, j0, i), a),
                      a.scale),
            p_qk, bits);
      }
      S[i] = s;
    }
    __syncthreads();
    // each page's max over its keys
    for (int b = warp; b < np; b += kDecWarps) {
      const int nv = b == np - 1 ? nkeys - b * page : page;
      float mx = -INFINITY;
      for (int c = lane; c < nv; c += 32) mx = fmaxf(mx, S[b * page + c]);
      mx = warp_max(mx);
      if (lane == 0) bmax[b] = mx;
    }
    __syncthreads();
    // p = exp(s - m_safe), m_safe from the running max through the key's
    // page (a max: the order of the fmaxf is free)
    for (int i = tid; i < nkeys; i += kDecThreads) {
      float mm = m;
      for (int b = 0; b <= page_of(i, a); ++b) mm = fmaxf(mm, bmax[b]);
      const float safe = isfinite(mm) ? mm : 0.0f;
      const float s = S[i];
      S[i] = isfinite(s) ? expf(__fsub_rn(s, safe)) : 0.0f;
    }
    if (nkeys <= kDecKeys) __pipeline_wait_prior(0);
    __syncthreads();
    // each page's sum in fwd_kernel's order: 64-key chunks, key c with
    // c + 32, then the butterfly; chunk sums added in order
    for (int b = warp; b < np; b += kDecWarps) {
      const int nv = b == np - 1 ? nkeys - b * page : page;
      const float* row = S + b * page;
      float sum = 0.0f;
      for (int cc = 0; cc < nv; cc += kTK) {
        const float x0 = cc + lane < nv ? row[cc + lane] : 0.0f;
        const float x1 = cc + 32 + lane < nv ? row[cc + 32 + lane] : 0.0f;
        sum = __fadd_rn(sum, warp_sum(__fadd_rn(x0, x1)));
      }
      if (lane == 0) bsum[b] = sum;
    }
    // each page's P.V partial: one fmaf chain per column over the page's
    // keys in order, rounded once (av site, stream = logical page)
    if (nkeys <= kDecKeys) {
      for (int t = tid; t < np * dv; t += kDecThreads) {
        const int b = t / dv, c = t - b * dv;
        const int i0 = b * page;
        const int i1 = i0 + (b == np - 1 ? nkeys - i0 : page);
        const float x =
            pv_chain<kKind, DK>(0.0f, S, Vs, 0, i0, i1, c, kv_end, a);
        const uint32_t bits =
            t == tid ? av_bits : draw_bits(p_av, w + 2, j0 + b, r, c);
        PR[t] = round_bits(x, p_av, bits);
      }
    } else {   // one page, its V rows staged kDecKeys at a time
      float x[kCols];
#pragma unroll
      for (int u = 0; u < kCols; ++u) x[u] = 0.0f;
      for (int p0 = 0; p0 < nkeys; p0 += kDecKeys) {
        const int p1 = min(p0 + kDecKeys, nkeys);
        if (p0 > 0) {
          __syncthreads();
          stage_v<kKind, DK, kContig>(Vs, a, table, hrow, j0, p0, p1,
                                      length, vrow);
        }
        __pipeline_wait_prior(0);
        __syncthreads();
#pragma unroll
        for (int u = 0; u < kCols; ++u) {
          const int c = tid + kDecThreads * u;
          if (c < dv)
            x[u] = pv_chain<kKind, DK>(x[u], S, Vs, p0, p0, p1, c, kv_end, a);
        }
      }
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int c = tid + kDecThreads * u;
        if (c < dv)
          PR[c] = round_bits(x[u], p_av,
                             u == 0 ? av_bits
                                    : draw_bits(p_av, w + 2, j0, r, c));
      }
    }
    __syncthreads();
    // close the pages in order: m_new, corr, l and acc as fwd_kernel does
    // (every thread keeps m and l)
    for (int b = 0; b < np; ++b) {
      const float m_new = fmaxf(m, bmax[b]);
      const float safe = isfinite(m_new) ? m_new : 0.0f;
      const float corr = isfinite(m) ? expf(__fsub_rn(m, safe)) : 0.0f;
      m = m_new;
      l = __fadd_rn(__fmul_rn(l, corr), bsum[b]);
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int c = tid + kDecThreads * u;
        if (c < dv)
          acc[u] = __fadd_rn(__fmul_rn(acc[u], corr), PR[b * dv + c]);
      }
    }
    if (j0 + per_round < n_vis) {   // the next round's first draws
      qk_bits = draw_bits(p_qk, w, 0u, r, (j0 + per_round) * page + tid);
      av_bits = draw_bits(p_av, w + 2, j0 + per_round + b0, r, c0);
    }
  }
  // fwd_kernel closes every page past the length too, with no key: max
  // -inf (m stays), sum 0, partial round_site(+0) = +0.  That step maps
  // acc to acc * corr + 0 with corr 1 or 0 (m finite or not), and applied
  // twice it gives what it gives once (-0 becomes +0), so once stands for
  // all of them.
  if (n_vis < a.n_max) {
    const float safe = isfinite(m) ? m : 0.0f;
    const float corr = isfinite(m) ? expf(__fsub_rn(m, safe)) : 0.0f;
    l = __fadd_rn(__fmul_rn(l, corr), 0.0f);
#pragma unroll
    for (int u = 0; u < kCols; ++u)
      acc[u] = __fadd_rn(__fmul_rn(acc[u], corr), 0.0f);
  }
#pragma unroll
  for (int u = 0; u < kCols; ++u) {
    const int c = tid + kDecThreads * u;
    if (c < dv)
      a.out[(static_cast<size_t>(bh) * a.G + r) * dv + c] = round_bits(
          __fdiv_rn(acc[u], fmaxf(l, 1e-30f)), p_out, out_bits[u]);
  }
}

// ---------------------------------------------------------------------------
// K7 / K7': backward.
// ---------------------------------------------------------------------------
struct BwdArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* dO;
  const float* m;
  const float* l;
  const float* d;
  const uint32_t* seeds;   // dq: [qk | dq]; dkv: [qk | dk | dv]
  float* dq;
  float* dk;
  float* dv;
  Geo g;
  Sites sites;
};

// Row statistics of query row q (global index within the head): m_safe,
// 1 / l (0 where l = 0) and d.
__device__ __forceinline__ void load_row_stats(const BwdArgs& a, size_t idx,
                                               float* safe, float* linv,
                                               float* dd) {
  const float m = a.m[idx], l = a.l[idx];
  *safe = isfinite(m) ? m : 0.0f;
  *linv = l > 0.0f ? __fdiv_rn(1.0f, l) : 0.0f;
  *dd = a.d[idx];
}

// p and ds of one valid (query, key) pair: the reference's _bwd_p_ds.
__device__ __forceinline__ void p_ds(const float* q, const float* k,
                                     const float* dO, const float* v,
                                     float safe, float linv, float dd,
                                     const Geo& g, const rt::RoundParams& pq,
                                     const uint32_t* w, uint32_t qpos,
                                     uint32_t kpos, float* p, float* ds) {
  const float s = qk_logit(q, k, g, pq, w, qpos, kpos);
  *p = __fmul_rn(expf(__fsub_rn(s, safe)), linv);
  const float dp = dot(dO, v, g.dv);
  *ds = __fmul_rn(__fmul_rn(*p, __fsub_rn(dp, dd)), g.scale);
}

// kAccN outputs per thread (kAcc: d up to kDNarrow, kAccWide: up to
// kDMax), an instance each, as fwd_kernel's.
template <int kAccN>
__global__ void __launch_bounds__(kThreads) dq_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const Geo& g = a.g;
  const int bh = blockIdx.y;
  const int r0 = blockIdx.x * kTQ;
  const int nr = min(kTQ, g.rows - r0);
  const int ldk = g.dk + 1, ldv = g.dv + 1;
  float* Qs = smem;                  // kTQ x dk
  float* dOs = Qs + kTQ * g.dk;      // kTQ x dv
  float* Ks = dOs + kTQ * g.dv;      // kTK x ldk
  float* Vs = Ks + kTK * ldk;        // kTK x ldv
  float* Ds = Vs + kTK * ldv;        // kTQ x kTK
  float* row_safe = Ds + kTQ * kTK;
  float* row_linv = row_safe + kTQ;
  float* row_d = row_linv + kTQ;
  const int tid = threadIdx.x;
  const uint32_t* w = a.seeds + static_cast<size_t>(bh) * 4;
  const size_t qbase = static_cast<size_t>(bh) * g.rows + r0;
  const size_t kv_base = static_cast<size_t>(kv_of(bh, g)) * g.kv_rows;

  for (int e = tid; e < kTQ * g.dk; e += kThreads)
    Qs[e] = e / g.dk < nr ? a.q[qbase * g.dk + e] : 0.0f;
  for (int e = tid; e < kTQ * g.dv; e += kThreads)
    dOs[e] = e / g.dv < nr ? a.dO[qbase * g.dv + e] : 0.0f;
  if (tid < nr)
    load_row_stats(a, qbase + tid, row_safe + tid, row_linv + tid,
                   row_d + tid);
  float acc[kAccN], part[kAccN];
#pragma unroll
  for (int u = 0; u < kAccN; ++u) acc[u] = 0.0f;
  const int qpos_hi = g.q_offset + r0 + nr - 1;
  const int n_k = (g.kv_rows + g.kb - 1) / g.kb;

  for (int j = 0; j < n_k; ++j) {
    const int k0 = j * g.kb, k1 = min(k0 + g.kb, g.kv_rows);
#pragma unroll
    for (int u = 0; u < kAccN; ++u) part[u] = 0.0f;
    for (int t0 = k0; t0 < k1; t0 += kTK) {
      if (g.causal && t0 > qpos_hi) break;
      const int t1 = min(t0 + kTK, k1);
      __syncthreads();
      for (int e = tid; e < kTK * g.dk; e += kThreads) {
        const int c = e / g.dk, t = e % g.dk;
        Ks[c * ldk + t] = t0 + c < t1 ? a.k[(kv_base + t0 + c) * g.dk + t]
                                      : 0.0f;
      }
      for (int e = tid; e < kTK * g.dv; e += kThreads) {
        const int c = e / g.dv, t = e % g.dv;
        Vs[c * ldv + t] = t0 + c < t1 ? a.v[(kv_base + t0 + c) * g.dv + t]
                                      : 0.0f;
      }
      __syncthreads();
      for (int e = tid; e < kTQ * kTK; e += kThreads) {
        const int r = e / kTK, c = e % kTK, kpos = t0 + c;
        const int qpos = g.q_offset + r0 + r;
        float p = 0.0f, ds = 0.0f;
        if (r < nr && kpos < t1 && valid(qpos, kpos, g))
          p_ds(Qs + r * g.dk, Ks + c * ldk, dOs + r * g.dv, Vs + c * ldv,
               row_safe[r], row_linv[r], row_d[r], g, a.sites.p[0], w, qpos,
               kpos, &p, &ds);
        Ds[e] = ds;
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kAccN; ++u) {
        const int e = tid + kThreads * u;
        if (e < kTQ * g.dk) {
          const int r = e / g.dk, c = e % g.dk;
          float x = part[u];
          for (int kk = 0; kk < t1 - t0; ++kk)
            x = fmaf(Ds[r * kTK + kk], Ks[kk * ldk + c], x);
          part[u] = x;
        }
      }
    }
    // the kv block's dq contribution, rounded once (stream j)
#pragma unroll
    for (int u = 0; u < kAccN; ++u) {
      const int e = tid + kThreads * u;
      if (e < kTQ * g.dk) {
        const int r = e / g.dk, c = e % g.dk;
        acc[u] = __fadd_rn(acc[u], round_site(part[u], a.sites.p[1], w + 2,
                                              static_cast<uint32_t>(j),
                                              g.q_offset + r0 + r, c));
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kAccN; ++u) {
    const int e = tid + kThreads * u;
    if (e < kTQ * g.dk && e / g.dk < nr) a.dq[qbase * g.dk + e] = acc[u];
  }
}

// kAccN: kAccKV (d up to kDNarrow) or kAccKVWide (up to kDMax).
template <int kAccN>
__global__ void __launch_bounds__(kThreads) dkv_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const Geo& g = a.g;
  const int bh = blockIdx.y;
  const int c0 = blockIdx.x * kTKV;
  const int nc = min(kTKV, g.kv_rows - c0);
  const int ldk = g.dk + 1, ldv = g.dv + 1, ldp = kTKV + 1;
  float* Ks = smem;                  // kTKV x ldk
  float* Vs = Ks + kTKV * ldk;       // kTKV x ldv
  float* Qs = Vs + kTKV * ldv;       // kTQB x dk
  float* dOs = Qs + kTQB * g.dk;     // kTQB x dv
  float* Ps = dOs + kTQB * g.dv;     // kTQB x ldp
  float* Ds = Ps + kTQB * ldp;       // kTQB x ldp
  float* row_safe = Ds + kTQB * ldp;
  float* row_linv = row_safe + kTQB;
  float* row_d = row_linv + kTQB;
  const int tid = threadIdx.x;
  const uint32_t* w = a.seeds + static_cast<size_t>(bh) * 6;
  const size_t kv_base = static_cast<size_t>(kv_of(bh, g)) * g.kv_rows + c0;
  const size_t qhead = static_cast<size_t>(bh) * g.rows;

  for (int e = tid; e < kTKV * g.dk; e += kThreads) {
    const int c = e / g.dk, t = e % g.dk;
    Ks[c * ldk + t] = c < nc ? a.k[(kv_base + c) * g.dk + t] : 0.0f;
  }
  for (int e = tid; e < kTKV * g.dv; e += kThreads) {
    const int c = e / g.dv, t = e % g.dv;
    Vs[c * ldv + t] = c < nc ? a.v[(kv_base + c) * g.dv + t] : 0.0f;
  }
  float acc_k[kAccN], part_k[kAccN], acc_v[kAccN], part_v[kAccN];
#pragma unroll
  for (int u = 0; u < kAccN; ++u) acc_k[u] = acc_v[u] = 0.0f;
  const int n_q = (g.rows + g.qb - 1) / g.qb;

  for (int i = 0; i < n_q; ++i) {
    const int q0 = i * g.qb, q1 = min(q0 + g.qb, g.rows);
#pragma unroll
    for (int u = 0; u < kAccN; ++u) part_k[u] = part_v[u] = 0.0f;
    for (int rq0 = q0; rq0 < q1; rq0 += kTQB) {
      const int nq = min(kTQB, q1 - rq0);
      if (g.causal && g.q_offset + rq0 + nq - 1 < c0) continue;
      __syncthreads();
      for (int e = tid; e < kTQB * g.dk; e += kThreads)
        Qs[e] = e / g.dk < nq ? a.q[(qhead + rq0) * g.dk + e] : 0.0f;
      for (int e = tid; e < kTQB * g.dv; e += kThreads)
        dOs[e] = e / g.dv < nq ? a.dO[(qhead + rq0) * g.dv + e] : 0.0f;
      if (tid < nq)
        load_row_stats(a, qhead + rq0 + tid, row_safe + tid, row_linv + tid,
                       row_d + tid);
      __syncthreads();
      for (int e = tid; e < kTQB * kTKV; e += kThreads) {
        const int r = e / kTKV, c = e % kTKV;
        const int qpos = g.q_offset + rq0 + r, kpos = c0 + c;
        float p = 0.0f, ds = 0.0f;
        if (r < nq && c < nc && valid(qpos, kpos, g))
          p_ds(Qs + r * g.dk, Ks + c * ldk, dOs + r * g.dv, Vs + c * ldv,
               row_safe[r], row_linv[r], row_d[r], g, a.sites.p[0], w, qpos,
               kpos, &p, &ds);
        Ps[r * ldp + c] = p;
        Ds[r * ldp + c] = ds;
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kAccN; ++u) {
        const int e = tid + kThreads * u;
        if (e < kTKV * g.dv) {
          const int c = e / g.dv, cc = e % g.dv;
          float x = part_v[u];
          for (int r = 0; r < nq; ++r)
            x = fmaf(Ps[r * ldp + c], dOs[r * g.dv + cc], x);
          part_v[u] = x;
        }
        if (e < kTKV * g.dk) {
          const int c = e / g.dk, cc = e % g.dk;
          float x = part_k[u];
          for (int r = 0; r < nq; ++r)
            x = fmaf(Ds[r * ldp + c], Qs[r * g.dk + cc], x);
          part_k[u] = x;
        }
      }
    }
    // the q block's dk (qk spec) and dv (av spec) contributions, rounded
    // once each, keyed by (k position, column) on stream i
#pragma unroll
    for (int u = 0; u < kAccN; ++u) {
      const int e = tid + kThreads * u;
      if (e < kTKV * g.dv) {
        const int c = e / g.dv, cc = e % g.dv;
        acc_v[u] = __fadd_rn(acc_v[u],
                             round_site(part_v[u], a.sites.p[2], w + 4,
                                        static_cast<uint32_t>(i), c0 + c, cc));
      }
      if (e < kTKV * g.dk) {
        const int c = e / g.dk, cc = e % g.dk;
        acc_k[u] = __fadd_rn(acc_k[u],
                             round_site(part_k[u], a.sites.p[1], w + 2,
                                        static_cast<uint32_t>(i), c0 + c, cc));
      }
    }
  }
  const size_t obase = static_cast<size_t>(bh) * g.kv_rows + c0;
#pragma unroll
  for (int u = 0; u < kAccN; ++u) {
    const int e = tid + kThreads * u;
    if (e < kTKV * g.dv && e / g.dv < nc) a.dv[obase * g.dv + e] = acc_v[u];
    if (e < kTKV * g.dk && e / g.dk < nc) a.dk[obase * g.dk + e] = acc_k[u];
  }
}

// ---------------------------------------------------------------------------
// K7 / K7': the tiled backward (dq_tile_kernel, dkv_tile_kernel).
// ---------------------------------------------------------------------------
// Each block takes kBR rows of one head -- query rows (K7) or keys (K7')
// -- and walks the other side in tiles of kBT rows: 64 and 64 up to d =
// 128, 32 and 32 at d = 256, where 64-row blocks would not fit in shared
// memory (410,368 and 295,680 B).  Per tile, thread (rq, kq) = (tid /
// (kBT / 4), tid % (kBT / 4)) computes the kPairRows x 4 pairs of rows
// kPairRows rq.. and keys 4 kq..: 16 (or 4 at d = 256) logit chains and as
// many dp chains from float4 shared loads (k and v rows swizzled by
// 16-byte chunk), the four keys' qk draws of a row from one or two
// Threefry evaluations (site_bits4), then p and ds exactly as p_ds forms
// them, written once to shared memory.  The products follow: a thread owns
// kBR D / (4 kThreads) rows x 4 columns of dq (K7), or of dk and dv (K7').
//
// Bitwise the first versions.  Every chain keeps its operands and order:
// a logit is qk_logit's fmaf chain over t = 0..d-1, dp is dot's, dq sums
// its keys in order (fmaf(ds, k, x)), dk and dv their query rows in order;
// p, ds and the row statistics are p_ds's and load_row_stats'; each
// logical block's contribution is rounded once where the first version
// rounds it (dq: stream j at (q position, column); dk, dv: stream i at (k
// position, column)) and added to a sum that starts at +0.  A chain takes
// exactly the terms the first version's did, the masked pairs' zeros
// included, and no other (fmaf(+0, x, -0) is +0): the first versions cut
// by their 32-row (K7) or 32-key (K7') blocks, so each thread cuts its
// chains by the 32-row or 32-key block its own rows lie in -- K7 at that
// block's causal edge in the first version's 64-key tiles (whole tiles of
// kBT keys), K7' after the 32-row tiles whose rows all precede that
// block's first key.

// rows of a tiled block and of a tile at head dim d (BwdShape::kBR, kBT)
__host__ __device__ constexpr int bwd_rows(int d) { return d > 128 ? 32 : 64; }

template <int D>
struct BwdShape {
  static constexpr int kChunks = D / 4;
  static constexpr int kSwizzle = FwdShape<D>::kSwizzle;
  static constexpr int kBR = bwd_rows(D);   // query rows (K7), keys (K7')
  static constexpr int kBT = kBR;           // keys (K7), query rows (K7')
  static constexpr int kRows = kBR * kChunks / kThreads;   // output rows
  // the pairs of a tile: kBT / 4 key quads, kPairRows rows a thread
  static constexpr int kQuads = kBT / 4;
  static constexpr int kPairRows = kBR * kBT / (4 * kThreads);
  // two blocks per SM where their shared memory fits (d <= 64)
  static constexpr int kMinBlocks = D <= 64 ? 2 : 1;
  static_assert(kTK % kBT == 0 && kBR % kTQ == 0 && kBT % kTQB == 0,
                "tiles and blocks cut the first versions' tiles whole");
};

size_t dq_tile_smem(int d) {   // q, dO; two k and two v tiles; ds; stats
  const size_t r = bwd_rows(d);
  return sizeof(float) * (2 * r * d + 4 * r * d + r * r + 3 * r);
}

size_t dkv_tile_smem(int d) {  // k, v; a q and a dO tile; p, ds; stats
  const size_t r = bwd_rows(d);
  return sizeof(float) * (2 * r * d + 2 * r * d + 2 * r * r + 3 * r);
}

// The PR x 4 dot products of rows PR rq.. of A (row stride D) with rows
// 4 kq.. of the swizzled B, each an fmaf chain over t = 0..D-1 in order.
template <int D, int PR>
__device__ __forceinline__ void patch_dots(const float* A, const float* B,
                                           int rq, int kq,
                                           float (&s)[PR][4]) {
  using S = BwdShape<D>;
#pragma unroll
  for (int r = 0; r < PR; ++r)
    s[r][0] = s[r][1] = s[r][2] = s[r][3] = 0.0f;
#pragma unroll 4
  for (int t = 0; t < D; t += 4) {
    float4 af[PR], bf[4];
#pragma unroll
    for (int r = 0; r < PR; ++r)
      af[r] = *reinterpret_cast<const float4*>(A + (PR * rq + r) * D + t);
    const int pch = (t / 4) ^ (kq & S::kSwizzle);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      bf[c] = *reinterpret_cast<const float4*>(B + (4 * kq + c) * D +
                                               4 * pch);
#pragma unroll
    for (int r = 0; r < PR; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = fmaf(af[r].x, bf[c].x, s[r][c]);
        s[r][c] = fmaf(af[r].y, bf[c].y, s[r][c]);
        s[r][c] = fmaf(af[r].z, bf[c].z, s[r][c]);
        s[r][c] = fmaf(af[r].w, bf[c].w, s[r][c]);
      }
  }
}

// p and ds of valid pair (qpos, kpos) from its logit and dp chains: p_ds.
__device__ __forceinline__ void pair_p_ds(float s, float dp, float safe,
                                          float linv, float dd,
                                          const rt::RoundParams& pq,
                                          uint32_t bits, float scale,
                                          float* p, float* ds) {
  const float sv = round_bits(__fmul_rn(s, scale), pq, bits);
  *p = __fmul_rn(expf(__fsub_rn(sv, safe)), linv);
  *ds = __fmul_rn(__fmul_rn(*p, __fsub_rn(dp, dd)), scale);
}

// The keys of [k0, k1) that the first version's K7 visits for query
// positions up to qpos_hi: its 64-key tiles up to the causal edge.
__device__ __forceinline__ int dq_keys(int k0, int k1, int qpos_hi,
                                       const Geo& g) {
  if (!g.causal) return k1 - k0;
  return k0 > qpos_hi ? 0 : min(k1 - k0, ((qpos_hi - k0) / kTK + 1) * kTK);
}

// The first row (from q0) of q block [q0, q1) that the first version's K7'
// visits for keys from position cs on: its 32-row tiles whose last row
// precedes cs are skipped; q1 - q0 where all are.
__device__ __forceinline__ int dkv_first_row(int cs, int q0, int q1,
                                             const Geo& g) {
  if (!g.causal) return 0;
  const int before = cs - g.q_offset - q0;
  if (q1 - q0 - 1 < before) return q1 - q0;
  return before > 0 ? before / kTQB * kTQB : 0;
}

// One logical block's rounded contribution added to the sum in `out`
// (4 columns from c0 of one row, +0 before the first block).
__device__ __forceinline__ void add_rounded4(float* out, const float (&x)[4],
                                             bool first,
                                             const rt::RoundParams& p,
                                             const uint32_t* w,
                                             uint32_t stream, uint32_t row,
                                             uint32_t c0) {
  uint32_t bits[4];
  site_bits4(p, w, stream, row, c0, bits);
  float4* o = reinterpret_cast<float4*>(out);
  const float4 prev = first ? make_float4(0.0f, 0.0f, 0.0f, 0.0f) : *o;
  *o = make_float4(__fadd_rn(prev.x, round_bits(x[0], p, bits[0])),
                   __fadd_rn(prev.y, round_bits(x[1], p, bits[1])),
                   __fadd_rn(prev.z, round_bits(x[2], p, bits[2])),
                   __fadd_rn(prev.w, round_bits(x[3], p, bits[3])));
}

// N consecutive floats from shared memory, as wide as N allows.
template <int N>
__device__ __forceinline__ void load_run(const float* p, float (&x)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + i);
      x[i] = f.x;
      x[i + 1] = f.y;
      x[i + 2] = f.z;
      x[i + 3] = f.w;
    }
  } else if constexpr (N == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    x[0] = f.x;
    x[1] = f.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = p[i];
  }
}

// K7: kBR query rows of one head per block, the last rows' blocks (the
// heaviest under a causal mask) launched first.
template <int D>
__global__ void __launch_bounds__(kThreads, BwdShape<D>::kMinBlocks)
dq_tile_kernel(BwdArgs a) {
  using S = BwdShape<D>;
  constexpr int R = S::kRows, PR = S::kPairRows;
  constexpr int kBR = S::kBR, kBT = S::kBT;
  extern __shared__ float smem[];
  const Geo& g = a.g;
  const int bh = blockIdx.x;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kBR;
  const int nr = min(kBR, g.rows - r0);
  float* Qs = smem;                    // kBR x D
  float* dOs = Qs + kBR * D;           // kBR x D
  float* Ks = dOs + kBR * D;           // 2 x (kBT x D), swizzled
  float* Vs = Ks + 2 * kBT * D;        // 2 x (kBT x D), swizzled
  float* Ds = Vs + 2 * kBT * D;        // kBR x kBT
  float* row_safe = Ds + kBR * kBT;
  float* row_linv = row_safe + kBR;
  float* row_d = row_linv + kBR;
  const int tid = threadIdx.x;
  const uint32_t* w = a.seeds + static_cast<size_t>(bh) * 4;
  const rt::RoundParams& p_qk = a.sites.p[0];
  const size_t qbase = static_cast<size_t>(bh) * g.rows + r0;
  const size_t kvbase = static_cast<size_t>(kv_of(bh, g)) * g.kv_rows;
  const float* kbase = a.k + kvbase * D;
  const float* vbase = a.v + kvbase * D;

  copy_rows<D, false>(Qs, a.q + qbase * D, nr);
  copy_rows<D, false>(dOs, a.dO + qbase * D, nr);
  __pipeline_commit();
  for (int e = nr * D + tid; e < kBR * D; e += kThreads)
    Qs[e] = dOs[e] = 0.0f;
  if (tid < nr)
    load_row_stats(a, qbase + tid, row_safe + tid, row_linv + tid,
                   row_d + tid);
  else if (tid < kBR)
    row_safe[tid] = row_linv[tid] = row_d[tid] = 0.0f;
  const int kq = tid % S::kQuads, rq = tid / S::kQuads;     // pairs
  const int pc = tid % S::kChunks, pr = tid / S::kChunks;   // dq outputs
  // the causal edge of the block, and of the first version's 32-row block
  // that holds this thread's dq rows
  const int qpos_hi = g.q_offset + r0 + nr - 1;
  const int qpos_hi_g = g.q_offset + min(r0 + ((pr * R) & ~31) + 31,
                                         g.rows - 1);
  const int n_k = (g.kv_rows + g.kb - 1) / g.kb;

  for (int j = 0; j < n_k; ++j) {
    const int k0 = j * g.kb, k1 = min(k0 + g.kb, g.kv_rows);
    const int nkeys = dq_keys(k0, k1, qpos_hi, g);
    const int mykeys = dq_keys(k0, k1, qpos_hi_g, g);
    const int ntiles = (nkeys + kBT - 1) / kBT;
    float part[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
      part[r][0] = part[r][1] = part[r][2] = part[r][3] = 0.0f;
    if (ntiles > 0) {
      copy_rows<D, true>(Ks, kbase + static_cast<size_t>(k0) * D,
                         min(kBT, nkeys));
      copy_rows<D, true>(Vs, vbase + static_cast<size_t>(k0) * D,
                         min(kBT, nkeys));
      __pipeline_commit();
    }
    for (int i = 0; i < ntiles; ++i) {
      const int t0 = k0 + i * kBT;
      const int tl = min(kBT, nkeys - i * kBT);
      if (i + 1 < ntiles) {
        const int n1 = min(kBT, nkeys - (i + 1) * kBT);
        const int nb = ((i + 1) & 1) * kBT * D;
        copy_rows<D, true>(Ks + nb, kbase + static_cast<size_t>(t0 + kBT) * D,
                           n1);
        copy_rows<D, true>(Vs + nb, vbase + static_cast<size_t>(t0 + kBT) * D,
                           n1);
        __pipeline_commit();
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();
      const float* Kt = Ks + (i & 1) * kBT * D;
      const float* Vt = Vs + (i & 1) * kBT * D;
      {
        float s[PR][4], dp[PR][4];
        patch_dots<D, PR>(Qs, Kt, rq, kq, s);
        patch_dots<D, PR>(dOs, Vt, rq, kq, dp);
        const int kpos0 = t0 + 4 * kq;
#pragma unroll
        for (int r = 0; r < PR; ++r) {
          const int rr = PR * rq + r;
          const int qpos = g.q_offset + r0 + rr;
          uint32_t bits[4];
          site_bits4(p_qk, w, 0u, static_cast<uint32_t>(qpos),
                     static_cast<uint32_t>(kpos0), bits);
          float ds[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float p = 0.0f;
            ds[c] = 0.0f;
            if (rr < nr && 4 * kq + c < tl && valid(qpos, kpos0 + c, g))
              pair_p_ds(s[r][c], dp[r][c], row_safe[rr], row_linv[rr],
                        row_d[rr], p_qk, bits[c], g.scale, &p, &ds[c]);
          }
          *reinterpret_cast<float4*>(Ds + rr * kBT + 4 * kq) =
              make_float4(ds[0], ds[1], ds[2], ds[3]);
        }
      }
      __syncthreads();
      // dq += ds . k over the tile's keys in order, where this thread's
      // 32-row block visits the tile
      if (i * kBT < mykeys) {
        const float* drow = Ds + pr * R * kBT;
        int kk = 0;
        for (; kk + 4 <= tl; kk += 4) {
          float4 df[R], kf[4];
#pragma unroll
          for (int r = 0; r < R; ++r)
            df[r] = *reinterpret_cast<const float4*>(drow + r * kBT + kk);
          const int pch = pc ^ ((kk >> 2) & S::kSwizzle);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            kf[u] = *reinterpret_cast<const float4*>(Kt + (kk + u) * D +
                                                     4 * pch);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float du[4] = {df[r].x, df[r].y, df[r].z, df[r].w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              part[r][0] = fmaf(du[u], kf[u].x, part[r][0]);
              part[r][1] = fmaf(du[u], kf[u].y, part[r][1]);
              part[r][2] = fmaf(du[u], kf[u].z, part[r][2]);
              part[r][3] = fmaf(du[u], kf[u].w, part[r][3]);
            }
          }
        }
        for (; kk < tl; ++kk) {
          const int pch = pc ^ ((kk >> 2) & S::kSwizzle);
          const float4 kf =
              *reinterpret_cast<const float4*>(Kt + kk * D + 4 * pch);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float du = drow[r * kBT + kk];
            part[r][0] = fmaf(du, kf.x, part[r][0]);
            part[r][1] = fmaf(du, kf.y, part[r][1]);
            part[r][2] = fmaf(du, kf.z, part[r][2]);
            part[r][3] = fmaf(du, kf.w, part[r][3]);
          }
        }
      }
      __syncthreads();
    }
    // the kv block's dq contribution, rounded once (stream j)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int rr = pr * R + r;
      if (rr < nr)
        add_rounded4(a.dq + (qbase + rr) * D + 4 * pc, part[r], j == 0,
                     a.sites.p[1], w + 2, static_cast<uint32_t>(j),
                     static_cast<uint32_t>(g.q_offset + r0 + rr),
                     static_cast<uint32_t>(4 * pc));
    }
  }
  __pipeline_wait_prior(0);
}

// K7': kBR keys of one head per block (the first keys, the heaviest under
// a causal mask, launched first); per logical q block, q and dO in tiles
// of kBT rows.
template <int D>
__global__ void __launch_bounds__(kThreads, BwdShape<D>::kMinBlocks)
dkv_tile_kernel(BwdArgs a) {
  using S = BwdShape<D>;
  constexpr int R = S::kRows, PR = S::kPairRows;
  constexpr int kBR = S::kBR, kBT = S::kBT;
  extern __shared__ float smem[];
  const Geo& g = a.g;
  const int bh = blockIdx.x;
  const int c0 = blockIdx.y * kBR;
  const int nc = min(kBR, g.kv_rows - c0);
  float* Ks = smem;                    // kBR x D, swizzled
  float* Vs = Ks + kBR * D;            // kBR x D, swizzled
  float* Qs = Vs + kBR * D;            // kBT x D
  float* dOs = Qs + kBT * D;           // kBT x D
  float* Ps = dOs + kBT * D;           // kBT x kBR
  float* Ds = Ps + kBT * kBR;          // kBT x kBR
  float* row_safe = Ds + kBT * kBR;
  float* row_linv = row_safe + kBT;
  float* row_d = row_linv + kBT;
  const int tid = threadIdx.x;
  const uint32_t* w = a.seeds + static_cast<size_t>(bh) * 6;
  const rt::RoundParams& p_qk = a.sites.p[0];
  const size_t kvrow = static_cast<size_t>(kv_of(bh, g)) * g.kv_rows + c0;
  const size_t qhead = static_cast<size_t>(bh) * g.rows;
  const size_t obase = static_cast<size_t>(bh) * g.kv_rows + c0;

  copy_rows<D, true>(Ks, a.k + kvrow * D, nc);
  copy_rows<D, true>(Vs, a.v + kvrow * D, nc);
  __pipeline_commit();
  for (int e = nc * D + tid; e < kBR * D; e += kThreads)
    Ks[e] = Vs[e] = 0.0f;
  const int kq = tid % S::kQuads, rq = tid / S::kQuads;     // pairs
  const int pc = tid % S::kChunks, pk = tid / S::kChunks;   // dk, dv
  // the first key of the first version's 32-key block that holds this
  // thread's keys
  const int cs = c0 + ((pk * R) & ~31);
  const int n_q = (g.rows + g.qb - 1) / g.qb;

  for (int i = 0; i < n_q; ++i) {
    const int q0 = i * g.qb, q1 = min(q0 + g.qb, g.rows);
    const int beg = dkv_first_row(c0, q0, q1, g);
    const int mybeg = q0 + dkv_first_row(cs, q0, q1, g);
    float part_k[R][4], part_v[R][4];
#pragma unroll
    for (int k = 0; k < R; ++k)
#pragma unroll
      for (int c = 0; c < 4; ++c) part_k[k][c] = part_v[k][c] = 0.0f;
    for (int t0 = q0 + (beg < q1 - q0 ? beg / kBT * kBT : q1 - q0); t0 < q1;
         t0 += kBT) {
      const int nq = min(kBT, q1 - t0);
      __syncthreads();   // the previous tile is read
      copy_rows<D, false>(Qs, a.q + (qhead + t0) * D, nq);
      copy_rows<D, false>(dOs, a.dO + (qhead + t0) * D, nq);
      __pipeline_commit();
      for (int e = nq * D + tid; e < kBT * D; e += kThreads)
        Qs[e] = dOs[e] = 0.0f;
      if (tid < nq)
        load_row_stats(a, qhead + t0 + tid, row_safe + tid, row_linv + tid,
                       row_d + tid);
      else if (tid < kBT)
        row_safe[tid] = row_linv[tid] = row_d[tid] = 0.0f;
      __pipeline_wait_prior(0);
      __syncthreads();
      {
        float s[PR][4], dp[PR][4];
        patch_dots<D, PR>(Qs, Ks, rq, kq, s);
        patch_dots<D, PR>(dOs, Vs, rq, kq, dp);
        const int kpos0 = c0 + 4 * kq;
#pragma unroll
        for (int r = 0; r < PR; ++r) {
          const int rr = PR * rq + r;
          const int qpos = g.q_offset + t0 + rr;
          uint32_t bits[4];
          site_bits4(p_qk, w, 0u, static_cast<uint32_t>(qpos),
                     static_cast<uint32_t>(kpos0), bits);
          float p[4], ds[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            p[c] = ds[c] = 0.0f;
            if (rr < nq && 4 * kq + c < nc && valid(qpos, kpos0 + c, g))
              pair_p_ds(s[r][c], dp[r][c], row_safe[rr], row_linv[rr],
                        row_d[rr], p_qk, bits[c], g.scale, &p[c], &ds[c]);
          }
          *reinterpret_cast<float4*>(Ps + rr * kBR + 4 * kq) =
              make_float4(p[0], p[1], p[2], p[3]);
          *reinterpret_cast<float4*>(Ds + rr * kBR + 4 * kq) =
              make_float4(ds[0], ds[1], ds[2], ds[3]);
        }
      }
      __syncthreads();
      // dv += p^T . dO and dk += ds^T . q over the tile's rows in order,
      // from the first row this thread's 32-key block visits
#pragma unroll 4
      for (int r = max(0, mybeg - t0); r < nq; ++r) {
        float pr[R], dsr[R];   // p and ds of row r at this thread's keys
        load_run<R>(Ps + r * kBR + pk * R, pr);
        load_run<R>(Ds + r * kBR + pk * R, dsr);
        const float4 o = *reinterpret_cast<const float4*>(dOs + r * D +
                                                          4 * pc);
        const float4 qv = *reinterpret_cast<const float4*>(Qs + r * D +
                                                           4 * pc);
#pragma unroll
        for (int k = 0; k < R; ++k) {
          part_v[k][0] = fmaf(pr[k], o.x, part_v[k][0]);
          part_v[k][1] = fmaf(pr[k], o.y, part_v[k][1]);
          part_v[k][2] = fmaf(pr[k], o.z, part_v[k][2]);
          part_v[k][3] = fmaf(pr[k], o.w, part_v[k][3]);
          part_k[k][0] = fmaf(dsr[k], qv.x, part_k[k][0]);
          part_k[k][1] = fmaf(dsr[k], qv.y, part_k[k][1]);
          part_k[k][2] = fmaf(dsr[k], qv.z, part_k[k][2]);
          part_k[k][3] = fmaf(dsr[k], qv.w, part_k[k][3]);
        }
      }
    }
    // the q block's dk (qk spec) and dv (av spec) contributions, rounded
    // once each, keyed by (k position, column) on stream i
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int kk = pk * R + k;
      if (kk >= nc) continue;
      const size_t o = (obase + kk) * D + 4 * pc;
      const uint32_t kpos = static_cast<uint32_t>(c0 + kk);
      add_rounded4(a.dk + o, part_k[k], i == 0, a.sites.p[1], w + 2,
                   static_cast<uint32_t>(i), kpos,
                   static_cast<uint32_t>(4 * pc));
      add_rounded4(a.dv + o, part_v[k], i == 0, a.sites.p[2], w + 4,
                   static_cast<uint32_t>(i), kpos,
                   static_cast<uint32_t>(4 * pc));
    }
  }
  __pipeline_wait_prior(0);
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------
Sites make_sites(const int* ints, const float* xmax, int n) {
  Sites s{};
  for (int i = 0; i < n; ++i) {
    const int* p = ints + 6 * i;
    s.p[i] = rt::RoundParams{p[0], p[1], p[2], xmax[i], p[3], p[4], p[5]};
  }
  return s;
}

Geo make_geo(int rows, int kv_rows, int dk, int dv, int n_heads, int n_kv,
             int qb, int kb, int q_offset, int causal, int window,
             float scale) {
  return Geo{rows,     kv_rows, dk,     dv,    n_heads, n_kv, qb, kb,
             q_offset, causal,  window, scale, 0,       0};
}

template <typename Kernel, typename Args>
int launch(Kernel kernel, dim3 grid, size_t smem, const Args& args,
           void* stream, int threads = kThreads) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// The decode kernel's instance for a cache kind and head dim (0: any dk,
// dv).
template <int kKind, bool kContig>
int launch_decode(int d, dim3 grid, size_t smem, const DecodeArgs& a,
                  void* stream) {
  switch (d) {
    case 16: return launch(decode_paged_kernel<kKind, 16, kContig>, grid,
                           smem, a, stream, kDecThreads);
    case 32: return launch(decode_paged_kernel<kKind, 32, kContig>, grid,
                           smem, a, stream, kDecThreads);
    case 64: return launch(decode_paged_kernel<kKind, 64, kContig>, grid,
                           smem, a, stream, kDecThreads);
    case 128: return launch(decode_paged_kernel<kKind, 128, kContig>, grid,
                            smem, a, stream, kDecThreads);
    case 256: return launch(decode_paged_kernel<kKind, 256, kContig>, grid,
                            smem, a, stream, kDecThreads);
    default: return launch(decode_paged_kernel<kKind, 0, kContig>, grid,
                           smem, a, stream, kDecThreads);
  }
}

// The tiled backward kernels: the SM's shared memory all as shared memory,
// so that two blocks fit where dq_tile_smem / dkv_tile_smem allow.
template <typename Kernel>
int launch_bwd(Kernel kernel, dim3 grid, size_t smem, const BwdArgs& a,
               void* stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch(kernel, grid, smem, a, stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The decode kernel over a paged pool (kContig false: lengths, tables) or
// a contiguous (B.KV, stride, d) cache read as pages of `page` keys
// (kContig true: one length, n_kv 1).  pack: code bytes (0 = float32
// cache), ebits, mbits, emin, has_nf.  Refused where a block's shared
// memory would not fit or a draw width is not 32, 16 or 8.
template <bool kContig>
int decode_launch(const float* q, const void* k, const void* v,
                  const int* pack, const uint32_t* seeds, const int* lengths,
                  const int* tables, float* out, int BKV, int G, int n_kv,
                  int n_max, int page, int stride, int length, int dk,
                  int dv, int window, float scale, const int* site_ints,
                  const float* site_xmax, void* stream) {
  if (dk > kDMax || dv > kDMax || dk < 1 || dv < 1 || page < 1 ||
      n_kv < 1 || n_max < 1 || G < 1 || BKV % n_kv != 0 ||
      BKV / n_kv > 65535 || n_kv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Sites sites = make_sites(site_ints, site_xmax, 3);
  for (const rt::RoundParams& p : sites.p)   // draw_bits' widths
    if (p.enabled && p.mode != rt::kRN && p.rand_bits != 32 &&
        p.rand_bits != 16 && p.rand_bits != 8)
      return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = pack[0], ebits = pack[1], mbits = pack[2];
  const int emin = pack[3], has_nf = pack[4];
  // 1-byte codes by dec8 where its rebasing multiply is exact
  const bool byte8 = bytes == 1 && emin >= -120 && emin <= 1;
  const int kind = bytes == 0 ? kF32
                   : byte8   ? (has_nf ? kByteNF : kByte)
                             : kCode;
  const int elt = bytes == 0 ? 4 : bytes;
  const int nb = ebits + mbits;
  int page_shift = -1;
  for (int s = 0; s < 31; ++s)
    if (page == (1 << s)) page_shift = s;
  const DecodeArgs a{q,
                     k,
                     v,
                     bytes,
                     rt::PackParams{ebits, mbits, emin, has_nf},
                     31 - nb,
                     (1u << nb) - 1u,
                     23 - mbits,
                     (1u << ebits) - 1u,
                     byte8 ? std::ldexp(1.0f, 126 + emin) : 0.0f,
                     seeds,
                     lengths,
                     tables,
                     out,
                     G,
                     n_kv,
                     n_max,
                     page,
                     page_shift,
                     dk,
                     dv,
                     window,
                     scale,
                     sites,
                     stride,
                     length};
  const size_t smem = decode_smem(page, dk, dv, elt, kContig ? 0 : n_max);
  if (smem > static_cast<size_t>(kSmemMax))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(G, n_kv, BKV / n_kv);
  // the head dim fixed at compile time where dk == dv and rows start on
  // 16-byte boundaries
  const bool vec = aligned16(k) && aligned16(v) && (dk * elt) % 16 == 0;
  const int d = vec && dk == dv && kind != kCode ? dk : 0;
  switch (kind) {
    case kF32: return launch_decode<kF32, kContig>(d, grid, smem, a, stream);
    case kByte: return launch_decode<kByte, kContig>(d, grid, smem, a,
                                                     stream);
    case kByteNF: return launch_decode<kByteNF, kContig>(d, grid, smem, a,
                                                         stream);
    default: return launch(decode_paged_kernel<kCode, 0, kContig>, grid,
                           smem, a, stream, kDecThreads);
  }
}

size_t fwd_smem(int dk, int dv) {
  return sizeof(float) * (kTQ * dk + kTK * (dk + 1) + kTK * dv + kTQ * kTK +
                          5 * kTQ);
}

// fwd_kernel for a call: its kAcc instance where the head dims allow.
int launch_fwd_kernel(const FwdArgs& a, dim3 grid, void* stream) {
  const Geo& g = a.g;
  if (g.dk > kDMax || g.dv > kDMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fwd_smem(g.dk, g.dv);
  if (g.dk <= kDNarrow && g.dv <= kDNarrow)
    return launch(fwd_kernel<kAcc>, grid, smem, a, stream);
  return launch(fwd_kernel<kAccWide>, grid, smem, a, stream);
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError().
// site_ints: per site precision, emin, emax, mode, rand_bits, enabled;
// site_xmax: per site xmax.
//
// K6: the single-pass forward (fwd1_kernel), for dk == dv in {16, 32, 64,
// 128, 256} where a block's logits fit in shared memory (fwd1_smem); any
// other shape is refused, and the wrapper launches flash_fwd_two_pass
// instead (d up to 256).
extern "C" int flash_fwd(const float* q, const float* k, const float* v,
                         const uint32_t* seeds, float* out, float* m,
                         float* l, float* s_out, int BH, int Sq, int Skv,
                         int dk, int dv, int n_heads, int n_kv, int qb,
                         int kb, int q_offset, int causal, int window,
                         float scale, const int* site_ints,
                         const float* site_xmax, void* stream) {
  const size_t smem = fwd1_smem(kb, dk);
  if (dk != dv || kb < 1 || smem > static_cast<size_t>(kSmemMax))
    return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a{q,     k, v,     0,     rt::PackParams{}, seeds,
            out,   m, l,     s_out,
            make_geo(Sq, Skv, dk, dv, n_heads, n_kv, qb, kb, q_offset,
                     causal, window, scale),
            make_sites(site_ints, site_xmax, 3)};
  const dim3 grid((Sq + kTQ - 1) / kTQ, BH);
  switch (dk) {
    case 16: return launch(fwd1_kernel<16>, grid, smem, a, stream);
    case 32: return launch(fwd1_kernel<32>, grid, smem, a, stream);
    case 64: return launch(fwd1_kernel<64>, grid, smem, a, stream);
    case 128: return launch(fwd1_kernel<128>, grid, smem, a, stream);
    case 256: return launch(fwd1_kernel<256>, grid, smem, a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K6's two-pass form (fwd_kernel), for the shapes flash_fwd refuses (dk
// and dv up to 256).
extern "C" int flash_fwd_two_pass(const float* q, const float* k,
                                  const float* v, const uint32_t* seeds,
                                  float* out, float* m, float* l,
                                  float* s_out, int BH, int Sq, int Skv,
                                  int dk, int dv, int n_heads, int n_kv,
                                  int qb, int kb, int q_offset, int causal,
                                  int window, float scale,
                                  const int* site_ints,
                                  const float* site_xmax, void* stream) {
  FwdArgs a{q,     k, v,     0,     rt::PackParams{}, seeds,
            out,   m, l,     s_out,
            make_geo(Sq, Skv, dk, dv, n_heads, n_kv, qb, kb, q_offset,
                     causal, window, scale),
            make_sites(site_ints, site_xmax, 3)};
  return launch_fwd_kernel(a, dim3((Sq + kTQ - 1) / kTQ, BH), stream);
}

// K9 (decode_paged_kernel in contiguous mode): k/v (B.KV, Smax, d)
// float32 or code words, read as pages of kb keys (a ragged last block
// where Smax % kb != 0), one block per (B.KV row, query row); bit for bit
// flash_decode_tiled.  pack as decode_launch takes it.  Refused where the
// logits of kb keys do not fit in shared memory (the wrapper launches
// flash_decode_tiled there).
extern "C" int flash_decode(const float* q, const void* k, const void* v,
                            const int* pack, const uint32_t* seeds,
                            float* out, int BKV, int G, int Smax, int dk,
                            int dv, int length, int kb, int window,
                            float scale, const int* site_ints,
                            const float* site_xmax, void* stream) {
  if (kb < 1 || kb > Smax || length < 1 || length > Smax)
    return static_cast<int>(cudaErrorInvalidValue);
  return decode_launch<true>(q, k, v, pack, seeds, nullptr, nullptr, out,
                             BKV, G, 1, (Smax + kb - 1) / kb, kb, Smax,
                             length, dk, dv, window, scale, site_ints,
                             site_xmax, stream);
}

// K9's first kernel (fwd_kernel, two passes per 64-key tile): the
// independent reference flash_decode is held against, and the route for
// blocks whose logits flash_decode cannot hold.
extern "C" int flash_decode_tiled(const float* q, const void* k,
                                  const void* v, const int* pack,
                                  const uint32_t* seeds, float* out, int BKV,
                                  int G, int Smax, int dk, int dv,
                                  int length, int kb, int window,
                                  float scale, const int* site_ints,
                                  const float* site_xmax, void* stream) {
  Geo g = make_geo(G, Smax, dk, dv, 1, 1, G, kb, 0, 1, window, scale);
  g.decode = 1;
  g.length = length;
  FwdArgs a{q,
            k,
            v,
            pack[0],
            rt::PackParams{pack[1], pack[2], pack[3], pack[4]},
            seeds,
            out,
            nullptr,
            nullptr,
            nullptr,
            g,
            make_sites(site_ints, site_xmax, 3)};
  return launch_fwd_kernel(a, dim3((G + kTQ - 1) / kTQ, BKV), stream);
}

// K10 (decode_paged_kernel over a pool).  pages: (P.KV, page, d) float32
// or code words (pack as above); lengths (B,) and tables (B, n_max) int32
// on the device.  Refused where a block's shared memory would not fit
// (pages whose logits do not).
extern "C" int flash_decode_paged(const float* q, const void* k,
                                  const void* v, const int* pack,
                                  const uint32_t* seeds, const int* lengths,
                                  const int* tables, float* out, int BKV,
                                  int G, int n_kv, int n_max, int page,
                                  int dk, int dv, int window, float scale,
                                  const int* site_ints,
                                  const float* site_xmax, void* stream) {
  return decode_launch<false>(q, k, v, pack, seeds, lengths, tables, out,
                              BKV, G, n_kv, n_max, page, 0, 0, dk, dv,
                              window, scale, site_ints, site_xmax, stream);
}

// K7: the tiled kernel (dq_tile_kernel), for dk == dv in {16, 32, 64,
// 128, 256}; any other shape is refused, and the wrapper launches
// flash_bwd_dq_simple instead.  Bit for bit flash_bwd_dq_simple.
extern "C" int flash_bwd_dq(const float* q, const float* k, const float* v,
                            const float* dO, const float* m, const float* l,
                            const float* d, const uint32_t* seeds, float* dq,
                            int BH, int Sq, int Skv, int dk, int dv,
                            int n_heads, int n_kv, int qb, int kb,
                            int q_offset, int causal, int window, float scale,
                            const int* site_ints, const float* site_xmax,
                            void* stream) {
  const size_t smem = dq_tile_smem(dk);
  const dim3 grid(BH, (Sq + bwd_rows(dk) - 1) / bwd_rows(dk));
  if (dk != dv || kb < 1 || smem > static_cast<size_t>(kSmemMax) ||
      grid.y > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{q,  k,       v,       dO, m, l, d, seeds, dq, nullptr, nullptr,
            make_geo(Sq, Skv, dk, dv, n_heads, n_kv, qb, kb, q_offset,
                     causal, window, scale),
            make_sites(site_ints, site_xmax, 2)};
  switch (dk) {
    case 16: return launch_bwd(dq_tile_kernel<16>, grid, smem, a, stream);
    case 32: return launch_bwd(dq_tile_kernel<32>, grid, smem, a, stream);
    case 64: return launch_bwd(dq_tile_kernel<64>, grid, smem, a, stream);
    case 128: return launch_bwd(dq_tile_kernel<128>, grid, smem, a, stream);
    case 256: return launch_bwd(dq_tile_kernel<256>, grid, smem, a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K7's first kernel (dq_kernel): the independent reference flash_bwd_dq is
// held against, and the route for the shapes it refuses (dk, dv up to
// 256: its wide instance above 128).
extern "C" int flash_bwd_dq_simple(const float* q, const float* k,
                                   const float* v, const float* dO,
                                   const float* m, const float* l,
                                   const float* d, const uint32_t* seeds,
                                   float* dq, int BH, int Sq, int Skv, int dk,
                                   int dv, int n_heads, int n_kv, int qb,
                                   int kb, int q_offset, int causal,
                                   int window, float scale,
                                   const int* site_ints,
                                   const float* site_xmax, void* stream) {
  if (dk > kDMax || dv > kDMax) return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{q,  k,       v,       dO, m, l, d, seeds, dq, nullptr, nullptr,
            make_geo(Sq, Skv, dk, dv, n_heads, n_kv, qb, kb, q_offset,
                     causal, window, scale),
            make_sites(site_ints, site_xmax, 2)};
  const size_t smem =
      sizeof(float) * (kTQ * dk + kTQ * dv + kTK * (dk + 1) + kTK * (dv + 1) +
                       kTQ * kTK + 3 * kTQ);
  const dim3 grid((Sq + kTQ - 1) / kTQ, BH);
  if (dk <= kDNarrow && dv <= kDNarrow)
    return launch(dq_kernel<kAcc>, grid, smem, a, stream);
  return launch(dq_kernel<kAccWide>, grid, smem, a, stream);
}

// K7': the tiled kernel (dkv_tile_kernel), for dk == dv in {16, 32, 64,
// 128, 256}; any other shape is refused, and the wrapper launches
// flash_bwd_dkv_simple instead.  Bit for bit flash_bwd_dkv_simple.
extern "C" int flash_bwd_dkv(const float* q, const float* k, const float* v,
                             const float* dO, const float* m, const float* l,
                             const float* d, const uint32_t* seeds,
                             float* dk_out, float* dv_out, int BH, int Sq,
                             int Skv, int dk, int dv, int n_heads, int n_kv,
                             int qb, int kb, int q_offset, int causal,
                             int window, float scale, const int* site_ints,
                             const float* site_xmax, void* stream) {
  const size_t smem = dkv_tile_smem(dk);
  const dim3 grid(BH, (Skv + bwd_rows(dk) - 1) / bwd_rows(dk));
  if (dk != dv || qb < 1 || smem > static_cast<size_t>(kSmemMax) ||
      grid.y > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{q, k, v, dO, m, l, d, seeds, nullptr, dk_out, dv_out,
            make_geo(Sq, Skv, dk, dv, n_heads, n_kv, qb, kb, q_offset,
                     causal, window, scale),
            make_sites(site_ints, site_xmax, 3)};
  switch (dk) {
    case 16: return launch_bwd(dkv_tile_kernel<16>, grid, smem, a, stream);
    case 32: return launch_bwd(dkv_tile_kernel<32>, grid, smem, a, stream);
    case 64: return launch_bwd(dkv_tile_kernel<64>, grid, smem, a, stream);
    case 128: return launch_bwd(dkv_tile_kernel<128>, grid, smem, a, stream);
    case 256: return launch_bwd(dkv_tile_kernel<256>, grid, smem, a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K7''s first kernel (dkv_kernel): the independent reference flash_bwd_dkv
// is held against, and the route for the shapes it refuses (dk, dv up to
// 256: its wide instance above 128).
extern "C" int flash_bwd_dkv_simple(const float* q, const float* k,
                                    const float* v, const float* dO,
                                    const float* m, const float* l,
                                    const float* d, const uint32_t* seeds,
                                    float* dk_out, float* dv_out, int BH,
                                    int Sq, int Skv, int dk, int dv,
                                    int n_heads, int n_kv, int qb, int kb,
                                    int q_offset, int causal, int window,
                                    float scale, const int* site_ints,
                                    const float* site_xmax, void* stream) {
  if (dk > kDMax || dv > kDMax) return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{q, k, v, dO, m, l, d, seeds, nullptr, dk_out, dv_out,
            make_geo(Sq, Skv, dk, dv, n_heads, n_kv, qb, kb, q_offset,
                     causal, window, scale),
            make_sites(site_ints, site_xmax, 3)};
  const size_t smem =
      sizeof(float) * (kTKV * (dk + 1) + kTKV * (dv + 1) + kTQB * dk +
                       kTQB * dv + 2 * kTQB * (kTKV + 1) + 3 * kTQB);
  const dim3 grid((Skv + kTKV - 1) / kTKV, BH);
  if (dk <= kDNarrow && dv <= kDNarrow)
    return launch(dkv_kernel<kAccKV>, grid, smem, a, stream);
  return launch(dkv_kernel<kAccKVWide>, grid, smem, a, stream);
}
