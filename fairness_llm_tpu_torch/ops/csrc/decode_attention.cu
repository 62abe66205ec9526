// Decode attention over each row's own KV cache, seeded by a prompt prefix
// shared by every row, for Hopper (sm_90a): one query per row, or a
// speculative verify window of Q queries per row, over a float or an int8
// cache.
//
// Replaces: fairness_llm_tpu/ops/decode_attention.py, `decode_attention`
// (the Pallas TPU kernels): 3-D q -> `_kernel`, float cache (K2) and its
// `quant=True` branch (K2q); 4-D q -> `_kernel_multi`, float and int8 cache
// (K3). Same function: q [B,Q,H,D] (Q = 1 for 3-D q) against the shared
// prefix k/v [P,Hkv,D] (always visible) followed by the row's cache k/v
// [B,L,Hkv,D] under valid [B,L]; for Q > 1 query i of row b sees cache slot
// j only where j <= q_offsets[b] + i. One joint online softmax in f32; scale
// D^-0.5; head h reads kv head h / rep; the output is acc / max(l, 1e-30).
// With an int8 cache (scales ks/vs [B,L,Hkv] f32) the k-scale multiplies
// the score before the mask and the max, the normaliser l sums the unscaled
// p, and PV takes p * v-scale; the prefix stays float.
//
// What bounds it on the H100: one query per row does ~4*D operations for
// every 2*2*D bytes of k/v it reads, about one operation per byte, so K2 is
// bound by the bytes of the cache and the prefix over 3.35 TB/s. A verify
// window of Q queries does Q times the operations on the same bytes (~18
// operations per byte for llama3-8b's 36 query rows per kv head): still on
// the bytes' side of the card's line, but only if the products run on the
// tensor cores; on scalar f32 FMAs they take longer than the bytes.
//
// The two bf16 routes are here, reported by the C entry; the float32 ones
// are in sources of their own, which build in parallel with this one and
// share combine_splits (combine_splits.cuh): decode_attention_f32.cu's
// decode_split_f32 (one query per row, K2 and K2q) and decode_verify_f32.cu's
// verify_split_f32 (the verify window over a float and an int8 cache, K3:
// key splits planned to fill the card, prefix blocks that take the query
// rows of every batch row of a kv head, cache tiles with no valid slot or
// past the rows' last visible slot skipped, register-tiled f32 FMAs).
//
// decode_verify_tc (bf16 verify window, Q > 1, over a bf16 or an int8
// cache), on mma.sync m16n8k16 as flash_attention.cu's flash_fwd_tc: the
// rep * Q rows of one kv head, row g being query g / rep of head
// hk * rep + g % rep, are the M side, 16 rows a warp and at most 4 warps a
// block (36 rows: 3 warps); more rows take more blocks over grid.y. Each
// lane loads its q fragments once, straight from device memory into
// registers, and knows its two rows' causal limits q_offsets[b] + g / rep.
// Each 32-key tile goes through tile_update: S = Q.K^T with K through
// ldmatrix, the online softmax on the C fragments in log2 units, and P
// packed from them into the A fragments of P.V, V through ldmatrix.trans.
// Tiles stream through a two-slot cp.async ring, rows padded by 16 bytes so
// ldmatrix reads are free of bank conflicts; the wrapper zero-pads D to 32,
// 64, 128 or 256. At D = 128 a block of 3 warps holds 168 registers a thread
// and 35-36 KB of shared memory, so four blocks share an SM (registers
// bound it); 64-key tiles, a third ring slot, or 208 registers without
// spills ran no faster on the card. The keys are split across blocks over
// grid.x, so that B * Hkv blocks (128 for llama3-8b at batch 16) become a
// full wave (the wrapper's plan: as many splits as four blocks an SM hold,
// 3 + 1 there): a split walks either prefix tiles or own-cache tiles, never
// both, so a tile never straddles the two and each ring slot holds one row
// type. Own-cache tiles past q_offsets[b] + Q - 1 are skipped (every row's
// limit excludes them). Over an int8 cache a cache split stages int8 k/v
// tiles with their 32 k and v scales and converts each tile once to bf16
// in a third slot (exact); the k-scale multiplies S's C fragments before the
// mask and the max, l sums the unscaled p, and p times the v-scale is what
// P.V takes. Each split writes f32 partials (m in log2 units, l, acc) to a
// workspace the wrapper allocates, and combine_splits folds them in split
// order (deterministic; a split in which a row saw no key has l = 0 and is
// skipped). Both launches come from one C call; with one split the kernel
// writes the output itself. P (times the v-scale) goes to P.V as two bf16
// terms, its rounding and the remainder (split_bf16x2, as flash_fwd_tc's;
// ROADMAP C9): with one term a row of few keys near cancellation missed the
// bf16 allowance. Their sum carries P to about 2^-17 of itself.
//
// decode_split_tc (bf16, one query per row: K2 over a bf16 cache, K2q over
// an int8 cache), on the same tile_update. The shared prefix is the same for
// every row, so a prefix block takes the B * rep query rows of one kv head
// (batch row b's heads hk * rep ..< (hk + 1) * rep, for every b) as its M
// side, in chunks of 64 rows (4 warps): at batch 16 and rep 4 one block per
// (kv head, prefix split) reads each prefix tile once for all 16 rows, where
// a block per batch row would read it 16 times. A cache block takes the rep
// rows of one (batch row, kv head) over a run of that row's own tiles (at
// rep 4 one live warp, 12 of its 16 rows padding: this side is bound by
// bytes, not operations; the other warps stage and convert). Before its run
// a cache block reads the valid bytes of its tiles into one mask word a
// tile: a tile with no valid slot is neither loaded nor computed, and a slot
// that is not valid is zero-filled instead of read, so the bytes read are
// the ones the row needs. Prefix splits and cache splits share one grid
// (prefix blocks first) planned to fill one wave (the wrapper's
// decode_splits), write partials in decode_verify_tc's layout with Q = 1,
// and combine_splits folds them; one C call, at most two launches. The
// query rows are staged once in shared memory and read through ldmatrix at
// every tile, which keeps a thread at 128 registers so four blocks share an
// SM at D <= 128 (52-54 KB of shared memory each). Over an int8 cache the
// cache tiles are converted as decode_verify_tc converts them.

#include "attention_common.cuh"
#include "combine_splits.cuh"
#include "mma_fragments.cuh"

namespace {

using namespace attn;

// ---------------------------------------------------------------------------
// bf16 verify window on the tensor cores, and the combine of its key splits
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 4;             // m-tiles of 16 query rows a block, at most
constexpr int kTcRows = 16 * kTcWarps;  // query rows of one kv head a block, at most
constexpr int kTcStages = 2;            // ring slots: tiles in flight while one is computed

// Tile shapes of one instantiated width DP: BK keys a tile (the wrapper's
// TILE_KEYS, from which it plans the splits), bf16 rows staged STR elements
// apart and int8 rows STR8 bytes apart (16 spare bytes a row, so ldmatrix
// and the conversion read free of bank conflicts). A ring slot holds a k
// and a v tile: SLOT bytes in bf16; SLOT8 in int8 with the tile's k and v
// scales. A float cache uses two bf16 slots; an int8 cache two bf16 slots
// (prefix splits) or two int8 slots and one bf16 slot for the converted
// tile (cache splits), whichever is larger. QROWS: a block's query rows
// staged in bf16 (decode_split_tc).
template <int DP>
struct TcShape {
  static constexpr int BK = 32;
  static constexpr int STR = DP + 8;
  static constexpr int STR8 = DP + 16;
  static constexpr int SLOT = 2 * BK * STR * 2;
  static constexpr int SLOT8 = 2 * BK * STR8 + 2 * BK * 4;
  static constexpr int SMEM_F = kTcStages * SLOT;
  static constexpr int SMEM_Q =
      kTcStages * SLOT8 + SLOT > SMEM_F ? kTcStages * SLOT8 + SLOT : SMEM_F;
  static constexpr int QROWS = kTcRows * STR * 2;
  static_assert(SLOT % 16 == 0 && SLOT8 % 16 == 0 && QROWS % 16 == 0,
                "slots keep 16-byte alignment");
};

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// int8 k and v tiles (2 * BK rows, STR8 bytes apart) -> bf16 (STR elements
// apart), 8 values a step: exact.
template <int DP>
__device__ __forceinline__ void convert_tiles(const int8_t* raw, bf16* dst) {
  using Sh = TcShape<DP>;
  constexpr int CPR = DP / 8;  // 8-byte chunks a row
  for (int i = threadIdx.x; i < 2 * Sh::BK * CPR; i += blockDim.x) {
    const int r = i / CPR, c = i % CPR;
    const uint2 w = *reinterpret_cast<const uint2*>(raw + r * Sh::STR8 + c * 8);
    float lo[4], hi[4];
    frag::i8x4_to_f32(w.x, lo);
    frag::i8x4_to_f32(w.y, hi);
    *reinterpret_cast<uint4*>(dst + r * Sh::STR + c * 8) =
        make_uint4(frag::pack_bf16x2(lo[0], lo[1]), frag::pack_bf16x2(lo[2], lo[3]),
                   frag::pack_bf16x2(hi[0], hi[1]), frag::pack_bf16x2(hi[2], hi[3]));
  }
}

// One BK-key tile for a warp's 16 query rows, on mma.sync m16n8k16: S = Q.K^T
// with Q's A fragment for k16 step ks from qfrag(ks, a) and the k tile at kt
// (BK rows, STR apart) through ldmatrix; the scores in log2 units (sl), times
// the k-scale where kss is given (an int8 cache tile: kss[0, BK) its k
// scales, kss[BK, 2 BK) its v scales), and, where edge is set, kNegInf
// wherever mask(c, hr) is false for key c of row half hr (row g: hr = 0, row
// g + 8: hr = 1). Then the online softmax on the C fragments (m in log2
// units; l sums the unscaled p, per lane) and acc += P.V, P (times the
// v-scale) packed from the score fragments, the v tile at kt + BK * STR
// through ldmatrix.trans.
template <int DP, typename QFrag, typename Mask>
__device__ __forceinline__ void tile_update(QFrag qfrag, const bf16* kt, const float* kss,
                                            float sl, bool edge, Mask mask, float (&m)[2],
                                            float (&l)[2], float (&acc)[DP / 8][4]) {
  using Sh = TcShape<DP>;
  constexpr int BK = Sh::BK, STR = Sh::STR;
  constexpr int NS = BK / 8;   // n8 score tiles a warp holds
  constexpr int KD = DP / 16;  // k16 steps over D
  const int lane = threadIdx.x % 32, q2 = (lane % 4) * 2;
  const bf16* vt = kt + BK * STR;

  // S = Q K^T: 16 rows x BK keys a warp.
  float s[NS][4];
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KD; ++ks) {
    uint32_t a[4];
    qfrag(ks, a);
#pragma unroll
    for (int jj = 0; jj < NS / 2; ++jj) {
      uint32_t r[4];
      frag::ldsm_x4(r, kt + (jj * 16 + lane % 8 + (lane / 16) * 8) * STR + ks * 16 +
                           ((lane / 8) % 2) * 8);
      frag::mma_bf16(s[2 * jj], a, r[0], r[1]);
      frag::mma_bf16(s[2 * jj + 1], a, r[2], r[3]);
    }
  }

  // Scores in log2 units, the k-scale folded in, then the mask where the
  // tile needs one.
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = j * 8 + q2 + (e & 1);
      float x = s[j][e] * sl;
      if (kss != nullptr) x *= kss[c];
      if (edge && !mask(c, e >> 1)) x = kNegInf;
      s[j][e] = x;
    }

  // Online softmax on the C fragments: row g holds e = 0, 1, row g + 8
  // e = 2, 3; a row's four lanes are a quad.
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mx = m[hr];
#pragma unroll
    for (int j = 0; j < NS; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // A row with no key yet keeps kNegInf; subtracting 0 then sends its
    // masked scores to exp2f(-1e30) = 0.
    const float mu = mx == kNegInf ? 0.f : mx;
    const float alpha = exp2f(m[hr] - mu);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][2 * hr] = exp2f(s[j][2 * hr] - mu);
      s[j][2 * hr + 1] = exp2f(s[j][2 * hr + 1] - mu);
      sum += s[j][2 * hr] + s[j][2 * hr + 1];
    }
    l[hr] = l[hr] * alpha + sum;  // unscaled p; the quad sums at the end
    m[hr] = mx;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      acc[j][2 * hr] *= alpha;
      acc[j][2 * hr + 1] *= alpha;
    }
  }

  // O += P V, P (times the v-scale over an int8 cache) straight from the
  // score fragments as two bf16 terms (its rounding pa and the remainder
  // pl, split_bf16x2), each a product with the same V fragment: one term
  // moved an output by up to 2^-9 of the largest |v| it averages, which a
  // row of few keys near cancellation does not absorb (ROADMAP C9, as C8
  // in flash_attention.cu); two carry P to about 2^-17.
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    float w[4] = {1.f, 1.f, 1.f, 1.f};  // keys 16kk + q2 + {0, 1}, then + 8
    if (kss != nullptr) {
      const float2 lo = *reinterpret_cast<const float2*>(kss + BK + kk * 16 + q2);
      const float2 hi = *reinterpret_cast<const float2*>(kss + BK + kk * 16 + 8 + q2);
      w[0] = lo.x, w[1] = lo.y, w[2] = hi.x, w[3] = hi.y;
    }
    uint32_t pa[4], pl[4];
    frag::split_bf16x2(s[2 * kk][0] * w[0], s[2 * kk][1] * w[1], pa[0], pl[0]);
    frag::split_bf16x2(s[2 * kk][2] * w[0], s[2 * kk][3] * w[1], pa[1], pl[1]);
    frag::split_bf16x2(s[2 * kk + 1][0] * w[2], s[2 * kk + 1][1] * w[3], pa[2], pl[2]);
    frag::split_bf16x2(s[2 * kk + 1][2] * w[2], s[2 * kk + 1][3] * w[3], pa[3], pl[3]);
#pragma unroll
    for (int dd = 0; dd < DP / 16; ++dd) {
      uint32_t r[4];
      frag::ldsm_x4_trans(r, vt + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * STR + dd * 16 +
                                 (lane / 16) * 8);
      frag::mma_bf16(acc[2 * dd], pa, r[0], r[1]);
      frag::mma_bf16(acc[2 * dd + 1], pa, r[2], r[3]);
      frag::mma_bf16(acc[2 * dd], pl, r[0], r[1]);
      frag::mma_bf16(acc[2 * dd + 1], pl, r[2], r[3]);
    }
  }
}

// A warp's partials for its rows g and g + 8 (orow(hr) < 0: no such row):
// with one split, acc / max(l, 1e-30) in bf16 to o; otherwise acc to ws at
// split s of nout rows, then (m, l). l is summed over the row's quad here.
template <int DP, typename ORow>
__device__ __forceinline__ void write_partials(ORow orow, const float (&m)[2], const float (&l)[2],
                                               const float (&acc)[DP / 8][4], bf16* o,
                                               float* ws, int split, int nsplit,
                                               long long nout) {
  const int lane = threadIdx.x % 32, q2 = (lane % 4) * 2;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lt = l[hr];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const long long r = orow(hr);
    if (r < 0) continue;  // padding rows are computed, never written
    if (nsplit == 1) {
      const float inv = 1.f / fmaxf(lt, 1e-30f);
      bf16* out = o + r * DP + q2;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + j * 8) =
            __floats2bfloat162_rn(acc[j][2 * hr] * inv, acc[j][2 * hr + 1] * inv);
    } else {
      const long long pr = split * nout + r;
      float* pacc = ws + pr * DP + q2;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
        *reinterpret_cast<float2*>(pacc + j * 8) = make_float2(acc[j][2 * hr], acc[j][2 * hr + 1]);
      if (lane % 4 == 0)
        reinterpret_cast<float2*>(ws + nsplit * nout * DP)[pr] = make_float2(m[hr], lt);
    }
  }
}

// One block per (key split, kv head and chunk of <= 64 query rows, batch
// row); see the note at the top of the file. QUANT: an int8 cache. Splits
// 0 ..< sp walk the prefix tiles, sp ..< sp + sc the own-cache tiles, each
// a run of whole tiles. With sp + sc == 1 the block writes o; otherwise its
// partials go to ws: acc [sp + sc][B*Q*H][DP], then (m, l) [sp + sc][B*Q*H].
template <int DP, bool QUANT>
__global__ void __launch_bounds__(kTcWarps * 32, DP >= 256 ? 1 : 3)
decode_verify_tc(const bf16* __restrict__ q, const void* __restrict__ kp,
                 const void* __restrict__ vp, const uint8_t* __restrict__ valid,
                 const bf16* __restrict__ sk, const bf16* __restrict__ sv,
                 const float* __restrict__ ksc, const float* __restrict__ vsc,
                 const int* __restrict__ qoff, bf16* __restrict__ o, float* __restrict__ ws,
                 int Q, int H, int Hkv, int L, int P, int sp, int sc, float scale) {
  using Sh = TcShape<DP>;
  constexpr int BK = Sh::BK, STR = Sh::STR, STR8 = Sh::STR8;
  constexpr int KD = DP / 16;  // k16 steps over D
  extern __shared__ __align__(16) unsigned char smem[];

  const int rep = H / Hkv, rows = rep * Q;
  const int split = blockIdx.x;
  const int hk = blockIdx.y % Hkv;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q2 = (lane % 4) * 2;
  const int row0 = (blockIdx.y / Hkv) * kTcRows + warp * 16;  // this warp's first row
  const bool live = row0 < rows;  // a warp wholly past the last row only helps load
  const int off = qoff[b];

  // The block's run of tiles [t0, t1): of the prefix, or of the own cache
  // cut at the tile of the last slot any query of the row may see.
  const bool pre = split < sp;
  int t0, t1;
  if (pre) {
    const int ntp = (P + BK - 1) / BK, per = (ntp + sp - 1) / sp;
    t0 = split * per;
    t1 = min(t0 + per, ntp);
  } else {
    const int ntc = (L + BK - 1) / BK, per = (ntc + sc - 1) / sc;
    const int last = off + Q - 1;
    t0 = (split - sp) * per;
    t1 = min(min(t0 + per, ntc), last < 0 ? 0 : last / BK + 1);
  }
  const int ntiles = max(t1 - t0, 0);

  const long long rs = (long long)Hkv * DP;  // elements from one key row to the next
  const long long cbase = (long long)b * L * rs + (long long)hk * DP;
  auto stage = [&](int t) {  // run tile t into ring slot t % kTcStages
    const int n0 = (t0 + t) * BK;
    if (QUANT && !pre) {
      const int8_t* kc = static_cast<const int8_t*>(kp) + cbase;
      const int8_t* vc = static_cast<const int8_t*>(vp) + cbase;
      int8_t* dst = reinterpret_cast<int8_t*>(smem + (t % kTcStages) * Sh::SLOT8);
      stage_rows<int8_t>(dst, BK, DP, kc, [&](int j) -> const int8_t* {
        return n0 + j < L ? kc + (n0 + j) * rs : nullptr;
      });
      stage_rows<int8_t>(dst + BK * STR8, BK, DP, vc, [&](int j) -> const int8_t* {
        return n0 + j < L ? vc + (n0 + j) * rs : nullptr;
      });
      float* scales = reinterpret_cast<float*>(dst + 2 * BK * STR8);  // k: BK, then v: BK
      for (int i = threadIdx.x; i < 2 * BK; i += blockDim.x) {
        const int j = i % BK;
        const bool in = n0 + j < L;
        const float* src = (i < BK ? ksc : vsc) + (in ? ((long long)b * L + n0 + j) * Hkv + hk : 0);
        cp_async4(scales + i, src, in);
      }
    } else {
      const bf16* kr = pre ? sk + hk * DP : static_cast<const bf16*>(kp) + cbase;
      const bf16* vr = pre ? sv + hk * DP : static_cast<const bf16*>(vp) + cbase;
      const int nkeys = pre ? P : L;
      bf16* dst = reinterpret_cast<bf16*>(smem + (t % kTcStages) * Sh::SLOT);
      stage_rows<bf16>(dst, BK, DP, kr, [&](int j) -> const bf16* {
        return n0 + j < nkeys ? kr + (n0 + j) * rs : nullptr;
      });
      stage_rows<bf16>(dst + BK * STR, BK, DP, vr, [&](int j) -> const bf16* {
        return n0 + j < nkeys ? vr + (n0 + j) * rs : nullptr;
      });
    }
  };
#pragma unroll
  for (int t = 0; t < kTcStages - 1; ++t) {
    if (t < ntiles) stage(t);
    cp_async_commit();
  }

  // q fragments, once, straight into registers (padding rows are zero).
  uint32_t qf[KD][4];
  {
    auto qrow = [&](int r) -> const bf16* {
      if (r >= rows) return nullptr;
      const int i = r / rep;
      return q + (((long long)b * Q + i) * H + (long long)hk * rep + (r - i * rep)) * DP;
    };
    const bf16* qa = qrow(row0 + g);
    const bf16* qb = qrow(row0 + g + 8);
#pragma unroll
    for (int ks = 0; ks < KD; ++ks) {
      qf[ks][0] = qa ? ldg32(qa + ks * 16 + q2) : 0u;
      qf[ks][1] = qb ? ldg32(qb + ks * 16 + q2) : 0u;
      qf[ks][2] = qa ? ldg32(qa + ks * 16 + 8 + q2) : 0u;
      qf[ks][3] = qb ? ldg32(qb + ks * 16 + 8 + q2) : 0u;
    }
  }
  auto qfrag = [&](int ks, uint32_t(&a)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) a[e] = qf[ks][e];
  };
  // The last own-cache slot each of this lane's rows (g, g + 8) may see.
  const int lim[2] = {off + (row0 + g) / rep, off + (row0 + g + 8) / rep};

  const float sl = scale * kLog2e;
  float acc[DP / 8][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // Own-cache tiles: each lane reads the valid bytes of slots n0 + 32h +
  // lane one tile ahead; a ballot at the tile makes them the tile's mask.
  constexpr int NV = BK / 32;
  const uint8_t* vrow = valid + (long long)b * L;
  int vnext[NV];
  auto read_valid = [&](int t) {
#pragma unroll
    for (int h = 0; h < NV; ++h) vnext[h] = vrow[min((t0 + t) * BK + h * 32 + lane, L - 1)];
  };
  if (!pre && ntiles > 0) read_valid(0);

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kTcStages - 2>();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if (t + kTcStages - 1 < ntiles) stage(t + kTcStages - 1);
    cp_async_commit();
    const int n0 = (t0 + t) * BK;
    const bf16* kt;
    const float* kss = nullptr;  // int8 cache: the tile's k scales, then its v scales
    if (QUANT && !pre) {
      const int8_t* raw = reinterpret_cast<const int8_t*>(smem + (t % kTcStages) * Sh::SLOT8);
      bf16* conv = reinterpret_cast<bf16*>(smem + kTcStages * Sh::SLOT8);
      convert_tiles<DP>(raw, conv);
      kss = reinterpret_cast<const float*>(raw + 2 * BK * STR8);
      kt = conv;
      __syncthreads();  // the converted tile is whole
    } else {
      kt = reinterpret_cast<const bf16*>(smem + (t % kTcStages) * Sh::SLOT);
    }
    if (!live) continue;

    uint32_t vmask[NV] = {};  // cache: bit i of word h, slot n0 + 32h + i is valid
    if (!pre) {
#pragma unroll
      for (int h = 0; h < NV; ++h)
        vmask[h] = __ballot_sync(0xffffffffu, n0 + h * 32 + lane < L && vnext[h] != 0);
      if (t + 1 < ntiles) read_valid(t + 1);
    }
    // A prefix key must exist; a cache slot must be valid and at most the
    // row's limit.
    tile_update<DP>(qfrag, kt, kss, sl, !pre || n0 + BK > P,
                    [&](int c, int hr) {
                      return pre ? n0 + c < P
                                 : ((vmask[c / 32] >> (c & 31)) & 1u) && n0 + c <= lim[hr];
                    },
                    m, l, acc);
  }
  cp_async_wait<0>();
  if (!live) return;

  write_partials<DP>(
      [&](int hr) -> long long {
        const int r = row0 + g + hr * 8;
        if (r >= rows) return -1;
        const int i = r / rep;
        return ((long long)b * Q + i) * H + (long long)hk * rep + (r - i * rep);
      },
      m, l, acc, o, ws, split, sp + sc, (long long)gridDim.z * Q * H);
}

// One query per row, bf16 (K2 over a bf16 cache, K2q over an int8 cache);
// see the note at the top of the file. Blocks [0, sp * Hkv * nrc) are
// prefix blocks: (prefix split, kv head hk, chunk of <= 64 of the B * rep
// query rows of hk, row r being head hk * rep + r % rep of batch row
// r / rep), nrc chunks a kv head. The rest are cache blocks: (cache split,
// batch row b, kv head hk), over the rep query rows of hk in row b. Splits
// are runs of whole tiles, numbered as decode_verify_tc numbers them, and
// the partials take its layout with Q = 1.
template <int DP, bool QUANT>
__global__ void __launch_bounds__(kTcWarps * 32, DP >= 256 ? 2 : 4)
decode_split_tc(const bf16* __restrict__ q, const void* __restrict__ kp,
                const void* __restrict__ vp, const uint8_t* __restrict__ valid,
                const bf16* __restrict__ sk, const bf16* __restrict__ sv,
                const float* __restrict__ ksc, const float* __restrict__ vsc,
                bf16* __restrict__ o, float* __restrict__ ws, int B, int H, int Hkv, int L,
                int P, int sp, int sc, float scale) {
  using Sh = TcShape<DP>;
  constexpr int BK = Sh::BK, STR = Sh::STR, STR8 = Sh::STR8;
  constexpr int RING = QUANT ? Sh::SMEM_Q : Sh::SMEM_F;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + RING);                        // [64][STR]
  uint32_t* tmask = reinterpret_cast<uint32_t*>(smem + RING + Sh::QROWS);  // [run]

  const int rep = H / Hkv, prows = B * rep;
  const int nrc = (prows + kTcRows - 1) / kTcRows;
  const int npre = sp * Hkv * nrc, bx = blockIdx.x;
  const bool pre = bx < npre;
  int hk, b = 0, split, rbase = 0;
  if (pre) {
    rbase = (bx % nrc) * kTcRows;
    hk = (bx / nrc) % Hkv;
    split = bx / (nrc * Hkv);
  } else {
    const int i = bx - npre;
    hk = i % Hkv;
    b = (i / Hkv) % B;
    split = sp + i / (Hkv * B);
  }
  // The output row (b * H + head) of block row r; -1 past the block's rows.
  auto orow_of = [&](int r) -> long long {
    if (!pre) return r < rep ? (long long)b * H + hk * rep + r : -1;
    r += rbase;
    if (r >= prows) return -1;
    const int bb = r / rep;
    return (long long)bb * H + hk * rep + (r - bb * rep);
  };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool live = orow_of(warp * 16) >= 0;  // a warp wholly past the rows only helps load

  // The block's run of tiles [t0, t1) of the prefix or of row b's cache.
  int t0, t1;
  if (pre) {
    const int ntp = (P + BK - 1) / BK, per = (ntp + sp - 1) / sp;
    t0 = split * per;
    t1 = min(t0 + per, ntp);
  } else {
    const int ntc = (L + BK - 1) / BK, per = (ntc + sc - 1) / sc;
    t0 = (split - sp) * per;
    t1 = min(t0 + per, ntc);
  }
  const int ntiles = max(t1 - t0, 0);

  // The query rows, to shared memory with the first tile (zeros past the
  // rows); a cache block's valid mask, one word a tile, each warp a tile.
  stage_rows<bf16>(qs, blockDim.x / 32 * 16, DP, q, [&](int r) -> const bf16* {
    const long long orow = orow_of(r);
    return orow < 0 ? nullptr : q + orow * DP;
  });
  const uint8_t* vrow = valid + (long long)b * L;
  if (!pre) {
    for (int t = warp; t < ntiles; t += blockDim.x / 32) {
      const int n = (t0 + t) * BK + lane;
      const uint32_t bits = __ballot_sync(0xffffffffu, n < L && vrow[n] != 0);
      if (lane == 0) tmask[t] = bits;
    }
  }
  __syncthreads();

  const long long rs = (long long)Hkv * DP;  // elements from one key row to the next
  const long long cbase = (long long)b * L * rs + (long long)hk * DP;
  // Run tile t into ring slot st. A cache slot that is not valid is
  // zero-filled, not read.
  auto stage = [&](int t, int st) {
    const int n0 = (t0 + t) * BK;
    if (pre) {
      const bf16* kr = sk + hk * DP;
      const bf16* vr = sv + hk * DP;
      bf16* dst = reinterpret_cast<bf16*>(smem + st * Sh::SLOT);
      stage_rows<bf16>(dst, BK, DP, kr, [&](int j) -> const bf16* {
        return n0 + j < P ? kr + (n0 + j) * rs : nullptr;
      });
      stage_rows<bf16>(dst + BK * STR, BK, DP, vr, [&](int j) -> const bf16* {
        return n0 + j < P ? vr + (n0 + j) * rs : nullptr;
      });
      return;
    }
    const uint32_t vm = tmask[t];
    if constexpr (QUANT) {
      const int8_t* kc = static_cast<const int8_t*>(kp) + cbase;
      const int8_t* vc = static_cast<const int8_t*>(vp) + cbase;
      int8_t* dst = reinterpret_cast<int8_t*>(smem + st * Sh::SLOT8);
      stage_rows<int8_t>(dst, BK, DP, kc, [&](int j) -> const int8_t* {
        return (vm >> j) & 1u ? kc + (n0 + j) * rs : nullptr;
      });
      stage_rows<int8_t>(dst + BK * STR8, BK, DP, vc, [&](int j) -> const int8_t* {
        return (vm >> j) & 1u ? vc + (n0 + j) * rs : nullptr;
      });
      float* scales = reinterpret_cast<float*>(dst + 2 * BK * STR8);  // k: BK, then v: BK
      for (int i = threadIdx.x; i < 2 * BK; i += blockDim.x) {
        const int j = i % BK;
        const bool in = (vm >> j) & 1u;
        const float* src = (i < BK ? ksc : vsc) + (in ? ((long long)b * L + n0 + j) * Hkv + hk : 0);
        cp_async4(scales + i, src, in);
      }
    } else {
      const bf16* kc = static_cast<const bf16*>(kp) + cbase;
      const bf16* vc = static_cast<const bf16*>(vp) + cbase;
      bf16* dst = reinterpret_cast<bf16*>(smem + st * Sh::SLOT);
      stage_rows<bf16>(dst, BK, DP, kc, [&](int j) -> const bf16* {
        return (vm >> j) & 1u ? kc + (n0 + j) * rs : nullptr;
      });
      stage_rows<bf16>(dst + BK * STR, BK, DP, vc, [&](int j) -> const bf16* {
        return (vm >> j) & 1u ? vc + (n0 + j) * rs : nullptr;
      });
    }
  };
  // The next tile of the run from t on that has a key: a cache tile with no
  // valid slot is neither loaded nor computed.
  auto next_tile = [&](int t) {
    if (!pre)
      while (t < ntiles && tmask[t] == 0u) ++t;
    return t;
  };
  auto qfrag = [&](int ks, uint32_t(&a)[4]) {
    frag::ldsm_x4(a, qs + (warp * 16 + lane % 16) * STR + ks * 16 + (lane / 16) * 8);
  };

  const float sl = scale * kLog2e;
  float acc[DP / 8][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  int cur = next_tile(0);
  if (cur < ntiles) stage(cur, 0);
  cp_async_commit();  // the query rows are in this group too
  for (int it = 0; cur < ntiles; ++it) {
    const int nxt = next_tile(cur + 1);
    cp_async_wait<0>();
    __syncthreads();  // tile cur landed; every warp is done with the last one
    if (nxt < ntiles) stage(nxt, (it + 1) % kTcStages);
    cp_async_commit();
    const int st = it % kTcStages, n0 = (t0 + cur) * BK;
    const bf16* kt;
    const float* kss = nullptr;  // int8 cache: the tile's k scales, then its v scales
    if (QUANT && !pre) {
      const int8_t* raw = reinterpret_cast<const int8_t*>(smem + st * Sh::SLOT8);
      bf16* conv = reinterpret_cast<bf16*>(smem + kTcStages * Sh::SLOT8);
      convert_tiles<DP>(raw, conv);
      kss = reinterpret_cast<const float*>(raw + 2 * BK * STR8);
      kt = conv;
      __syncthreads();  // the converted tile is whole
    } else {
      kt = reinterpret_cast<const bf16*>(smem + st * Sh::SLOT);
    }
    if (live) {
      // A prefix key must exist (the last prefix tile may overhang P); a
      // cache slot must be valid.
      const uint32_t vm = pre ? 0u : tmask[cur];
      tile_update<DP>(qfrag, kt, kss, sl, pre ? n0 + BK > P : vm != 0xffffffffu,
                      [&](int c, int) { return pre ? n0 + c < P : ((vm >> c) & 1u) != 0u; },
                      m, l, acc);
    }
    cur = nxt;
  }
  cp_async_wait<0>();
  if (!live) return;

  const int g = lane / 4;
  write_partials<DP>([&](int hr) { return orow_of(warp * 16 + g + hr * 8); }, m, l, acc, o, ws,
                     split, sp + sc, (long long)B * H);
}

struct Args {
  const void *q, *k, *v;
  const uint8_t* valid;
  const void *sk, *sv;
  const float *ks, *vs;
  const int* qoff;
  void* o;
  float* ws;
  int B, Q, H, Hkv, L, D, P, sp, sc;
  float scale;
  cudaStream_t stream;
};

template <int DP, bool QUANT>
cudaError_t launch_verify(const Args& a) {
  using Sh = TcShape<DP>;
  const int ntp = (a.P + Sh::BK - 1) / Sh::BK, ntc = (a.L + Sh::BK - 1) / Sh::BK;
  const int nsplit = a.sp + a.sc;
  if (a.sp < (ntp > 0) || a.sp > ntp || a.sc < (ntc > 0) || a.sc > ntc ||
      (nsplit > 1 && a.ws == nullptr))
    return cudaErrorInvalidValue;
  const int rows = (a.H / a.Hkv) * a.Q;
  const int nrc = (rows + kTcRows - 1) / kTcRows;
  if ((long long)a.Hkv * nrc > 65535 || a.B > 65535) return cudaErrorInvalidValue;
  constexpr int smem = QUANT ? Sh::SMEM_Q : Sh::SMEM_F;
  auto kernel = decode_verify_tc<DP, QUANT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(nsplit, a.Hkv * nrc, a.B);
  const int warps = rows < kTcRows ? (rows + 15) / 16 : kTcWarps;
  kernel<<<grid, warps * 32, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), a.k, a.v, a.valid, static_cast<const bf16*>(a.sk),
      static_cast<const bf16*>(a.sv), a.ks, a.vs, a.qoff, static_cast<bf16*>(a.o), a.ws, a.Q,
      a.H, a.Hkv, a.L, a.P, a.sp, a.sc, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  return launch_combine<bf16>(a.ws, static_cast<bf16*>(a.o), nsplit,
                              (long long)a.B * a.Q * a.H, DP, a.stream);
}

// bf16 verify window: D must be an instantiated width and every row
// 16-byte aligned; anything else is refused (the wrapper pads), never sent
// elsewhere.
cudaError_t dispatch_verify_tc(const Args& a, bool kv_int8) {
  if (!(aligned16(a.q) && aligned16(a.k) && aligned16(a.v) && aligned16(a.o) &&
        (a.P == 0 || (aligned16(a.sk) && aligned16(a.sv))) &&
        (a.ws == nullptr || aligned16(a.ws))))
    return cudaErrorInvalidValue;
#define VERIFY_TC(DP) return kv_int8 ? launch_verify<DP, true>(a) : launch_verify<DP, false>(a)
  if (a.D == 32) VERIFY_TC(32);
  if (a.D == 64) VERIFY_TC(64);
  if (a.D == 128) VERIFY_TC(128);
  if (a.D == 256) VERIFY_TC(256);
#undef VERIFY_TC
  return cudaErrorInvalidValue;
}

template <int DP, bool QUANT>
cudaError_t launch_decode_tc(const Args& a) {
  using Sh = TcShape<DP>;
  const int ntp = (a.P + Sh::BK - 1) / Sh::BK, ntc = (a.L + Sh::BK - 1) / Sh::BK;
  const int nsplit = a.sp + a.sc;
  if (a.sp < (ntp > 0) || a.sp > ntp || a.sc < (ntc > 0) || a.sc > ntc ||
      (nsplit > 1 && a.ws == nullptr))
    return cudaErrorInvalidValue;
  const int rep = a.H / a.Hkv;
  const long long prows = (long long)a.B * rep;
  const long long nrc = (prows + kTcRows - 1) / kTcRows;
  const long long blocks = a.sp * a.Hkv * nrc + (long long)a.sc * a.B * a.Hkv;
  if (blocks > 0x7fffffffLL || prows > 0x7fffffffLL) return cudaErrorInvalidValue;
  // The ring, the query rows, and a cache block's masks (one word a tile of its run).
  const int run = a.sc > 0 ? (ntc + a.sc - 1) / a.sc : 0;
  const int smem = (QUANT ? Sh::SMEM_Q : Sh::SMEM_F) + Sh::QROWS + (4 * run + 15) / 16 * 16;
  auto kernel = decode_split_tc<DP, QUANT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int warps = prows < kTcRows ? (int)((prows + 15) / 16) : kTcWarps;
  kernel<<<(unsigned)blocks, warps * 32, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), a.k, a.v, a.valid, static_cast<const bf16*>(a.sk),
      static_cast<const bf16*>(a.sv), a.ks, a.vs, static_cast<bf16*>(a.o), a.ws, a.B, a.H,
      a.Hkv, a.L, a.P, a.sp, a.sc, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  return launch_combine<bf16>(a.ws, static_cast<bf16*>(a.o), nsplit, (long long)a.B * a.H, DP,
                              a.stream);
}

// bf16 one-query decode: as dispatch_verify_tc, refused unless D is an
// instantiated width and every row is 16-byte aligned.
cudaError_t dispatch_decode_tc(const Args& a, bool kv_int8) {
  if (!(aligned16(a.q) && aligned16(a.k) && aligned16(a.v) && aligned16(a.o) &&
        (a.P == 0 || (aligned16(a.sk) && aligned16(a.sv))) &&
        (a.ws == nullptr || aligned16(a.ws))))
    return cudaErrorInvalidValue;
#define DECODE_TC(DP) \
  return kv_int8 ? launch_decode_tc<DP, true>(a) : launch_decode_tc<DP, false>(a)
  if (a.D == 32) DECODE_TC(32);
  if (a.D == 64) DECODE_TC(64);
  if (a.D == 128) DECODE_TC(128);
  if (a.D == 256) DECODE_TC(256);
#undef DECODE_TC
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 1 = bfloat16 (q, the prefix, a float cache, the output); float32
// takes decode_attention_f32_fwd (one query per row) or
// decode_verify_f32_fwd (a verify window). kv_int8: the cache k/v are int8
// with scales ks/vs [B,L,Hkv] f32. q [B,Q,H,D] (Q = 1: one query per row;
// q_offsets is then ignored and may be null), k/v [B,L,Hkv,D], valid [B,L]
// (one byte per slot), sk/sv [P,Hkv,D] (ignored when P == 0), q_offsets [B]
// int32 (required for Q > 1), o like q; all contiguous. decode_split_tc (Q =
// 1) and decode_verify_tc (Q > 1) take D of 32, 64, 128 or 256, every row
// 16-byte aligned, and walk the keys in splits_prefix + splits_cache splits
// (1 <= splits_prefix <= ceil(P / BK) where P > 0, else 0; the same for
// splits_cache and L; BK = 32 keys), with ws, 16-byte aligned, holding
// (splits_prefix + splits_cache) * B * Q * H * (D + 2) floats where there is
// more than one split. Anything else returns cudaErrorInvalidValue;
// otherwise the CUDA error code of the launch. *kernel is set to the route
// launched: 1 = decode_verify_tc, 2 = decode_split_tc (each followed by
// combine_splits where it splits), -1 = none.
extern "C" int decode_attention_fwd(int dtype, int kv_int8, const void* q, const void* k,
                                    const void* v, const void* valid, const void* sk,
                                    const void* sv, const void* ks, const void* vs,
                                    const void* q_offsets, void* o, void* ws, int B, int Q,
                                    int H, int Hkv, int L, int D, int P, int splits_prefix,
                                    int splits_cache, float scale, void* stream, int* kernel) {
  *kernel = -1;
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || L < 0 || P < 0 || P + L <= 0 || Q < 1 || Q > 64)
    return (int)cudaErrorInvalidValue;
  if ((Q > 1 && q_offsets == nullptr) || (kv_int8 && L > 0 && (ks == nullptr || vs == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args a{q,    k,    v,    static_cast<const uint8_t*>(valid),
         P ? sk : nullptr, P ? sv : nullptr,
         static_cast<const float*>(ks), static_cast<const float*>(vs),
         Q > 1 ? static_cast<const int*>(q_offsets) : nullptr,
         o,    static_cast<float*>(ws),
         B,    Q,    H,    Hkv, L, D, P, splits_prefix, splits_cache, scale,
         static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  int launched;
  if (dtype == 1 && Q > 1) {
    err = dispatch_verify_tc(a, kv_int8 != 0);
    launched = 1;  // decode_verify_tc
  } else if (dtype == 1) {
    err = dispatch_decode_tc(a, kv_int8 != 0);
    launched = 2;  // decode_split_tc
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err == cudaSuccess) *kernel = launched;
  return (int)err;
}
