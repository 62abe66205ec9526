// The float32 speculative verify window for Hopper (sm_90a): the float32
// route of decode attention with Q > 1 queries a row (K3 over a float
// cache, and over an int8 cache), in a source of its own so that it builds
// in parallel with the others.
//
// Replaces: fairness_llm_tpu/ops/decode_attention.py, `decode_attention`
// (the Pallas TPU kernel), 4-D q -> `_kernel_multi`, float cache and its
// `quant=True` branch. Same function: q [B,Q,H,D] against the shared prefix
// k/v [P,Hkv,D] (always visible) followed by the row's cache k/v [B,L,Hkv,D]
// under valid [B,L], query i of row b seeing cache slot j only where j <=
// q_offsets[b] + i; one joint online softmax in f32; scale D^-0.5; head h
// reads kv head h / rep; the output is acc / max(l, 1e-30). With an int8
// cache (scales ks/vs [B,L,Hkv] f32) the k-scale multiplies the score before
// the max, the normaliser l sums the unscaled p, and PV takes p * v-scale;
// the prefix stays float.
//
// What bounds it on the H100: a verify window does Q times the operations
// of a one-query step on the same bytes: at llama3-8b's width (q
// [16,9,32,128], a 704-key prefix, 168 cache slots) ~1.85 GFLOP on ~6 MB,
// so on scalar f32 FMAs (67 TFLOP/s) the operations bound it, ~0.027 ms,
// and the shared prefix holds nearly all of them: it is one SGEMM a kv head,
// the B * rep * Q query rows of every batch row against the same keys. At
// the study checkpoints' shapes (head width 32, 18 or 9 rows a (batch row,
// kv head)) the work is a few microseconds of the card: a call's time is
// its launches and the chain of tiles a block walks.
//
// verify_split_f32, on scalar f32 FMAs (TF32 would break the float32
// allowance; 3xTF32 was not taken, as for decode_split_f32). The keys are
// split across blocks, each split a run of whole 32-key tiles of one kind,
// planned by the wrapper's verify_splits_f32 with the query rows a block
// (16, 32 or 64) by a cost formula fitted on the card: the busiest SM's
// share of the block-tiles' FMAs, its longest chain of tiles, each split's
// partials and the combine's launch. Each split writes f32 partials (m in log2 units, l, acc)
// and combine_splits (combine_splits.cuh) folds them in split order; with
// one split the block writes the output itself.
//
// A prefix block takes RB of the B * rep * Q query rows of one kv head (row
// r: batch row r / (rep * Q), query g / rep of head hk * rep + g % rep for g
// = r % (rep * Q)), so each prefix tile is read once a chunk of RB rows, not
// once a (batch row, chunk). A cache block takes RB of the rep * Q rows of
// one (batch row, kv head) over a run of that row's tiles, cut at the tile
// of the largest slot its rows may see. It first reads the valid bytes of
// its run into one mask word a tile: a tile with no valid slot is neither
// loaded nor computed, and a slot that is not valid is zero-filled, not
// read. An int8 tile is converted once to f32 in shared memory, the k-scale
// folded into k and the v-scale into v (exact products, then the same
// float path).
//
// A block is 4 warps over register tiles, with no branch in a row loop;
// each tile of a phase does as many FMAs as its 16-byte shared-memory loads
// can feed (a warp's 16-byte load takes the shared memory four clocks, in
// which the SM does 16 warp FMA instructions). Q.K^T: the 16 lanes of a row
// group own RB / 8 rows; lane (dq, kq) takes 8 keys (4 kq + (e & 3) + 16
// (e >> 2)) over a quarter of the head's 16-byte column chunks (dq, dq + 4,
// ...), 8 key rows and one query row a step for 32 FMAs a row (the key rows
// 4 apart, so a quarter-warp's loads are free of bank conflicts); the four
// dq lanes then reduce-scatter the partial scores (6 shuffles a row), each
// keeping two keys a row, and the row's max is taken over its 16 lanes. P
// goes to shared memory, and P.V gives thread t the accumulator of RB /
// (128 / TC) rows and 4 * CG / TC columns (TC = min(D / 4, 16) threads
// across a row's CG = D / 4 chunks), from 16-byte loads of four keys'
// weights and value rows. Tiles stream through a two-slot cp.async ring: the
// next tile's copies are issued behind the block barrier that ends the last
// tile's use of its slot, and land while the current tile is computed.
//
// Scores are in log2 units (q.k times the softmax scale times log2(e)). The
// wrapper pads D to 32, 64, 128 or 256 and every row to a 16-byte boundary.

#include "attention_common.cuh"
#include "combine_splits.cuh"

namespace {

using namespace attn;

constexpr int kThreads = 128;  // 4 warps
constexpr int kBK = 32;        // keys a tile
constexpr int kPS = 40;        // floats from one row of P to the next (conflict-free writes)

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Shared memory of a block at head width DW: the ring (two slots of a float
// k and v tile; over an int8 cache two int8 slots with their 64 scales and
// one float k and v tile they convert into), then the block's query rows,
// P, and a float pair a row (alpha a tile, m and l at the end).
template <int DW>
struct Layout {
  static constexpr int KS = DW + 4;    // floats from one staged row to the next
  static constexpr int KS8 = DW + 16;  // bytes from one staged int8 row to the next
  static constexpr size_t TILE = sizeof(float) * kBK * KS;
  static constexpr size_t SLOT = 2 * TILE;
  static constexpr size_t SLOT8 = align16(2 * kBK * KS8 + 2 * kBK * sizeof(float));
  static constexpr size_t RING = 2 * SLOT > 2 * SLOT8 + SLOT ? 2 * SLOT : 2 * SLOT8 + SLOT;
  static_assert(TILE % 16 == 0, "tiles keep 16-byte alignment");

  static size_t smem(int rb, int run) {
    return RING + align16(sizeof(float) * rb * KS) + align16(sizeof(float) * rb * kPS) +
           align16(sizeof(float) * 2 * rb) + align16(sizeof(uint32_t) * run);
  }
};

// See the note at the top of the file. Blocks [0, sp * Hkv * nrp) are
// prefix blocks: (prefix split, kv head hk, chunk of RB of hk's B * rep * Q
// rows), nrp chunks a kv head; the rest are cache blocks: (cache split,
// batch row b, kv head hk, chunk of RB of the rep * Q rows of hk in row b),
// nrc chunks. Splits are runs of whole tiles, numbered as decode_split_f32
// numbers them; with sp + sc > 1 the block writes partials in
// combine_splits' layout (acc [sp + sc][B * Q * H][DW], then (m, l)), else
// o. sl: the softmax scale times log2(e). The cache's type is picked at run
// time, so that the prefix path is built once a (width, rows).
template <int DW, int RB>
__global__ void __launch_bounds__(kThreads)
verify_split_f32(const float* __restrict__ q, const void* __restrict__ kp,
                 const void* __restrict__ vp, const uint8_t* __restrict__ valid,
                 const float* __restrict__ sk, const float* __restrict__ sv,
                 const float* __restrict__ ksc, const float* __restrict__ vsc,
                 const int* __restrict__ qoff, float* __restrict__ o, float* __restrict__ ws,
                 int B, int Q, int H, int Hkv, int L, int P, int sp, int sc, int kv_int8,
                 float sl) {
  using Ly = Layout<DW>;
  constexpr int KS = Ly::KS, KS8 = Ly::KS8;
  constexpr int RT = RB / 8;  // score rows a thread
  constexpr int CG = DW / 4;  // 16-byte column chunks of a row
  constexpr int TC = CG < 16 ? CG : 16, RGP = kThreads / TC, RPV = RB / RGP, NC4 = CG / TC;
  static_assert(RB % 16 == 0 && RPV >= 1 && RB % RGP == 0, "whole row groups");
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + Ly::RING);                       // [RB][KS]
  float* ps = qs + align16(sizeof(float) * RB * KS) / sizeof(float);           // [RB][kPS]
  float* rowv = ps + align16(sizeof(float) * RB * kPS) / sizeof(float);        // [2][RB]
  uint32_t* tmask = reinterpret_cast<uint32_t*>(rowv + 2 * RB);                // [run]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rep = H / Hkv, rq = rep * Q;
  const int nrp = (B * rq + RB - 1) / RB, nrc = (rq + RB - 1) / RB;
  const int npre = sp * Hkv * nrp, bx = blockIdx.x;
  const bool pre = bx < npre;
  const bool kv8 = !pre && kv_int8;
  // The block's rows [r0, r1) among kv head hk's B * rq rows.
  int hk, b = 0, split, r0, r1;
  if (pre) {
    r0 = (bx % nrp) * RB;
    hk = (bx / nrp) % Hkv;
    split = bx / (nrp * Hkv);
    r1 = min(r0 + RB, B * rq);
  } else {
    const int i = bx - npre;
    hk = (i / nrc) % Hkv;
    b = (i / (nrc * Hkv)) % B;
    split = sp + i / (nrc * Hkv * B);
    r0 = b * rq + (i % nrc) * RB;
    r1 = min(r0 + RB, (b + 1) * rq);
  }
  // The output row (batch row * Q + query) * H + head of row r.
  auto orow = [&](int r) -> long long {
    const int bb = r / rq, g = r - bb * rq, i = g / rep;
    return ((long long)bb * Q + i) * H + (long long)hk * rep + (g - i * rep);
  };

  // The block's run of tiles [t0, t1): of the prefix, or of row b's cache cut
  // at the tile of the largest slot its rows may see.
  int t0, t1;
  if (pre) {
    const int ntp = (P + kBK - 1) / kBK, per = (ntp + sp - 1) / sp;
    t0 = split * per;
    t1 = min(t0 + per, ntp);
  } else {
    const int ntc = (L + kBK - 1) / kBK, per = (ntc + sc - 1) / sc;
    const int last = qoff[b] + (r1 - 1 - b * rq) / rep;
    t0 = (split - sp) * per;
    t1 = min(min(t0 + per, ntc), last < 0 ? 0 : last / kBK + 1);
  }
  const int ntiles = max(t1 - t0, 0);
  const int nsplit = sp + sc;
  const long long nout = (long long)B * Q * H;
  const long long rs = (long long)Hkv * DW;  // elements from one key row to the next

  // The query rows (zeros past r1), in the first copy group; a cache
  // block's valid mask, one word a tile, each warp a tile.
  stage_rows<float>(qs, RB, DW, q, [&](int j) -> const float* {
    return r0 + j < r1 ? q + orow(r0 + j) * DW : nullptr;
  });
  const uint8_t* vrow = valid + (long long)b * L;
  if (!pre) {
    for (int t = warp; t < ntiles; t += kThreads / 32) {
      const int n = (t0 + t) * kBK + lane;
      const uint32_t bits = __ballot_sync(0xffffffffu, n < L && vrow[n] != 0);
      if (lane == 0) tmask[t] = bits;
    }
  }
  __syncthreads();

  const float* skh = P ? sk + (long long)hk * DW : nullptr;
  const float* svh = P ? sv + (long long)hk * DW : nullptr;
  const long long cbase = (long long)b * L * rs + (long long)hk * DW;
  // Run tile t into ring slot st. A cache slot that is not valid is
  // zero-filled, not read.
  auto stage = [&](int t, int st) {
    const int n0 = (t0 + t) * kBK;
    if (pre) {
      float* dst = reinterpret_cast<float*>(smem + st * Ly::SLOT);
      stage_rows<float>(dst, kBK, DW, skh, [&](int j) -> const float* {
        return n0 + j < P ? skh + (n0 + j) * rs : nullptr;
      });
      stage_rows<float>(dst + kBK * KS, kBK, DW, svh, [&](int j) -> const float* {
        return n0 + j < P ? svh + (n0 + j) * rs : nullptr;
      });
      return;
    }
    const uint32_t vm = tmask[t];
    if (kv8) {
      const int8_t* kc = static_cast<const int8_t*>(kp) + cbase;
      const int8_t* vc = static_cast<const int8_t*>(vp) + cbase;
      int8_t* dst = reinterpret_cast<int8_t*>(smem + st * Ly::SLOT8);
      stage_rows<int8_t>(dst, kBK, DW, kc, [&](int j) -> const int8_t* {
        return (vm >> j) & 1u ? kc + (n0 + j) * rs : nullptr;
      });
      stage_rows<int8_t>(dst + kBK * KS8, kBK, DW, vc, [&](int j) -> const int8_t* {
        return (vm >> j) & 1u ? vc + (n0 + j) * rs : nullptr;
      });
      if (tid < 2 * kBK) {  // k scales, then v scales
        float* scales = reinterpret_cast<float*>(dst + 2 * kBK * KS8);
        const int j = tid % kBK;
        const bool in = (vm >> j) & 1u;
        const float* src =
            (tid < kBK ? ksc : vsc) + (in ? ((long long)b * L + n0 + j) * Hkv + hk : 0);
        cp_async4(scales + tid, src, in);
      }
    } else {
      const float* kc = static_cast<const float*>(kp) + cbase;
      const float* vc = static_cast<const float*>(vp) + cbase;
      float* dst = reinterpret_cast<float*>(smem + st * Ly::SLOT);
      stage_rows<float>(dst, kBK, DW, kc, [&](int j) -> const float* {
        return (vm >> j) & 1u ? kc + (n0 + j) * rs : nullptr;
      });
      stage_rows<float>(dst + kBK * KS, kBK, DW, vc, [&](int j) -> const float* {
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

  // Q.K^T and the softmax: lane (dq, kq) of row group rg (16 lanes) takes
  // rows rg + 8 i and keys 4 kq + (e & 3) + 16 (e >> 2) over the column
  // chunks dq, dq + 4, ...; the four dq lanes then reduce-scatter the
  // scores, and lane dq keeps keys kb and kb + 1 of each row.
  const int dq = lane % 4, kq = lane / 4 % 4, rg = tid / 16;
  const int kb = 4 * kq + 2 * (dq & 1) + 16 * (dq >> 1);
  int lim[RT];  // a cache block's last slot each row may see (-1: a row past r1)
  float m[RT], l[RT];  // l: this lane's keys; summed over the row's 16 lanes at the end
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = r0 + rg + 8 * i;
    lim[i] = pre || r >= r1 ? -1 : qoff[b] + (r - b * rq) / rep;
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  // P.V: rows rp + RGP j, 16-byte column chunks cl + TC c.
  const int cl = tid % TC, rp = tid / TC;
  float acc[RPV][NC4][4];
#pragma unroll
  for (int j = 0; j < RPV; ++j)
#pragma unroll
    for (int c = 0; c < NC4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][c][e] = 0.f;

  int cur = next_tile(0);
  if (cur < ntiles) stage(cur, 0);
  cp_async_commit();  // the query rows are in this group too
  for (int it = 0; cur < ntiles; ++it) {
    const int nxt = next_tile(cur + 1);
    cp_async_wait<0>();
    __syncthreads();  // tile cur landed; every thread is done with the last tile
    if (nxt < ntiles) stage(nxt, (it + 1) % 2);
    cp_async_commit();
    const int n0 = (t0 + cur) * kBK;
    const float* kt;
    if (kv8) {
      // The int8 tile to f32, k times its k-scale and v times its v-scale.
      const int8_t* raw = reinterpret_cast<const int8_t*>(smem + (it % 2) * Ly::SLOT8);
      const float* scales = reinterpret_cast<const float*>(raw + 2 * kBK * KS8);
      float* conv = reinterpret_cast<float*>(smem + 2 * Ly::SLOT8);
      constexpr int CPR = DW / 16;  // 16-byte int8 chunks a row
      for (int i = tid; i < 2 * kBK * CPR; i += kThreads) {
        const int r = i / CPR, c = (i - r * CPR) * 16;  // r < 32: k rows, then v rows
        float f[16];
        load_vec<int8_t>(raw + r * KS8 + c, f);
        const float s = scales[r];
        float4* dst = reinterpret_cast<float4*>(conv + r * KS + c);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dst[e] = make_float4(f[4 * e] * s, f[4 * e + 1] * s, f[4 * e + 2] * s, f[4 * e + 3] * s);
      }
      kt = conv;
      __syncthreads();  // the converted tile is whole
    } else {
      kt = reinterpret_cast<const float*>(smem + (it % 2) * Ly::SLOT);
    }
    const float* vt = kt + kBK * KS;

    float s[RT][8];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) s[i][e] = 0.f;
#pragma unroll 2
    for (int c = dq; c < CG; c += 4) {
      float4 kv[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        kv[e] = *reinterpret_cast<const float4*>(kt + (4 * kq + (e & 3) + 16 * (e >> 2)) * KS +
                                                 4 * c);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + (rg + 8 * i) * KS + 4 * c);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          s[i][e] = fmaf(qv.x, kv[e].x, s[i][e]);
          s[i][e] = fmaf(qv.y, kv[e].y, s[i][e]);
          s[i][e] = fmaf(qv.z, kv[e].z, s[i][e]);
          s[i][e] = fmaf(qv.w, kv[e].w, s[i][e]);
        }
      }
    }
    // Reduce-scatter over the dq lanes: lanes of dq bit 1 keep e of 4-7,
    // then lanes of dq bit 0 keep e & 3 of 2-3; lane dq ends with keys kb,
    // kb + 1.
    const bool hi2 = dq & 2, hi1 = dq & 1;
    float s2[RT][2];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float s4[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float send = hi2 ? s[i][j] : s[i][4 + j];
        s4[j] = (hi2 ? s[i][4 + j] : s[i][j]) + __shfl_xor_sync(0xffffffffu, send, 2);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float send = hi1 ? s4[j] : s4[2 + j];
        s2[i][j] = (hi1 ? s4[2 + j] : s4[j]) + __shfl_xor_sync(0xffffffffu, send, 1);
      }
    }
    // The online softmax in log2 units: a prefix key must exist (the last
    // prefix tile may overhang P); a cache slot must be valid and at most the
    // row's limit.
    const uint32_t vm = pre ? 0u : tmask[cur];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      bool vis[2];
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = kb + j;
        vis[j] = pre ? n0 + key < P : ((vm >> key) & 1u) && n0 + key <= lim[i];
        s2[i][j] *= sl;
        if (vis[j]) mx = fmaxf(mx, s2[i][j]);
      }
#pragma unroll
      for (int o = 1; o < 16; o *= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float alpha = exp2f(m[i] - mx);  // 1 while the row has seen no key
      const float p0 = vis[0] ? exp2f(s2[i][0] - mx) : 0.f;
      const float p1 = vis[1] ? exp2f(s2[i][1] - mx) : 0.f;
      l[i] = l[i] * alpha + p0 + p1;
      m[i] = mx;
      *reinterpret_cast<float2*>(ps + (rg + 8 * i) * kPS + kb) = make_float2(p0, p1);
      if (lane % 16 == 0) rowv[rg + 8 * i] = alpha;
    }
    __syncthreads();  // P and the rows' alphas are whole

    // acc = acc * alpha + P.V, four keys at a time.
#pragma unroll
    for (int j = 0; j < RPV; ++j) {
      const float a = rowv[rp + RGP * j];
#pragma unroll
      for (int c = 0; c < NC4; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][c][e] *= a;
    }
#pragma unroll 2
    for (int j4 = 0; j4 < kBK / 4; ++j4) {
      float4 vv[4][NC4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < NC4; ++c)
          vv[kk][c] = *reinterpret_cast<const float4*>(vt + (4 * j4 + kk) * KS + 4 * (cl + TC * c));
#pragma unroll
      for (int j = 0; j < RPV; ++j) {
        const float4 pv = *reinterpret_cast<const float4*>(ps + (rp + RGP * j) * kPS + 4 * j4);
        const float pk[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int c = 0; c < NC4; ++c) {
            acc[j][c][0] = fmaf(pk[kk], vv[kk][c].x, acc[j][c][0]);
            acc[j][c][1] = fmaf(pk[kk], vv[kk][c].y, acc[j][c][1]);
            acc[j][c][2] = fmaf(pk[kk], vv[kk][c].z, acc[j][c][2]);
            acc[j][c][3] = fmaf(pk[kk], vv[kk][c].w, acc[j][c][3]);
          }
      }
    }
    cur = nxt;
  }
  cp_async_wait<0>();

  // Each row's m and its l summed over the row's 16 lanes, to shared memory
  // for the threads that hold its accumulator.
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int o = 1; o < 16; o *= 2) l[i] += __shfl_xor_sync(0xffffffffu, l[i], o);
  __syncthreads();  // every thread is done with the last tile's alphas
  if (lane % 16 == 0) {
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      rowv[rg + 8 * i] = m[i];
      rowv[RB + rg + 8 * i] = l[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < RPV; ++j) {
    const int rr = rp + RGP * j;
    if (r0 + rr >= r1) continue;  // a row past the block's last: computed, never written
    const long long orr = orow(r0 + rr);
    if (nsplit == 1) {
      const float inv = 1.f / fmaxf(rowv[RB + rr], 1e-30f);
#pragma unroll
      for (int c = 0; c < NC4; ++c)
        *reinterpret_cast<float4*>(o + orr * DW + 4 * (cl + TC * c)) =
            make_float4(acc[j][c][0] * inv, acc[j][c][1] * inv, acc[j][c][2] * inv,
                        acc[j][c][3] * inv);
    } else {
      const long long pr = split * nout + orr;
#pragma unroll
      for (int c = 0; c < NC4; ++c)
        *reinterpret_cast<float4*>(ws + pr * DW + 4 * (cl + TC * c)) =
            make_float4(acc[j][c][0], acc[j][c][1], acc[j][c][2], acc[j][c][3]);
      if (cl == 0)
        reinterpret_cast<float2*>(ws + nsplit * nout * DW)[pr] = make_float2(rowv[rr], rowv[RB + rr]);
    }
  }
}

struct Args {
  const float* q;
  const void *k, *v;
  const uint8_t* valid;
  const float *sk, *sv, *ks, *vs;
  const int* qoff;
  float *o, *ws;
  int B, Q, H, Hkv, L, P, sp, sc;
  float scale;
  cudaStream_t stream;
};

template <int DW, int RB>
cudaError_t launch(const Args& a, bool kv_int8) {
  const int ntp = (a.P + kBK - 1) / kBK, ntc = (a.L + kBK - 1) / kBK;
  const int nsplit = a.sp + a.sc;
  if (a.sp < (ntp > 0) || a.sp > ntp || a.sc < (ntc > 0) || a.sc > ntc ||
      (nsplit > 1 && a.ws == nullptr))
    return cudaErrorInvalidValue;
  const long long rq = (long long)(a.H / a.Hkv) * a.Q;
  const long long nrp = (a.B * rq + RB - 1) / RB, nrc = (rq + RB - 1) / RB;
  const long long blocks = a.sp * a.Hkv * nrp + (long long)a.sc * a.B * a.Hkv * nrc;
  if (blocks > 0x7fffffffLL || a.B * rq > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int run = a.sc > 0 ? (ntc + a.sc - 1) / a.sc : 0;  // a cache block's mask words
  const size_t smem = Layout<DW>::smem(RB, run);
  auto kernel = verify_split_f32<DW, RB>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.valid, a.sk, a.sv, a.ks, a.vs, a.qoff, a.o, a.ws, a.B, a.Q, a.H, a.Hkv,
      a.L, a.P, a.sp, a.sc, kv_int8 ? 1 : 0, a.scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  return launch_combine<float>(a.ws, a.o, nsplit, (long long)a.B * a.Q * a.H, DW, a.stream);
}

// Rows a block: 16, 32 or 64 (at D = 256, 16 or 32: a thread's accumulators
// are rows x columns / 128, at most 64).
template <int DW>
cudaError_t dispatch_rows(const Args& a, int rb, bool kv_int8) {
  if (rb == 16) return launch<DW, 16>(a, kv_int8);
  if (rb == 32) return launch<DW, 32>(a, kv_int8);
  if constexpr (DW <= 128)
    if (rb == 64) return launch<DW, 64>(a, kv_int8);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(const Args& a, int D, int rb, bool kv_int8) {
  if (D == 32) return dispatch_rows<32>(a, rb, kv_int8);
  if (D == 64) return dispatch_rows<64>(a, rb, kv_int8);
  if (D == 128) return dispatch_rows<128>(a, rb, kv_int8);
  if (D == 256) return dispatch_rows<256>(a, rb, kv_int8);
  return cudaErrorInvalidValue;
}

}  // namespace

// The float32 verify window: q [B,Q,H,D] f32 (Q > 1) with q_offsets [B]
// int32, the prefix sk/sv [P,Hkv,D] f32 (ignored when P == 0), a float cache
// k/v [B,L,Hkv,D] f32 or (kv_int8) an int8 one with scales ks/vs [B,L,Hkv]
// f32, valid [B,L] (one byte a slot), o like q; all contiguous. D of 32, 64,
// 128 or 256; q, k, v, the prefix, o and ws 16-byte aligned. rows_per_block
// of 16, 32 or 64 (not 64 at D = 256). The keys are walked in splits_prefix
// + splits_cache splits (1 <= splits_prefix <= ceil(P / 32) where P > 0,
// else 0; the same for splits_cache and L), with ws holding (splits_prefix
// + splits_cache) * B * Q * H * (D + 2) floats where there is more than one
// split. Anything else returns cudaErrorInvalidValue; otherwise the CUDA
// error code of the launch. *kernel is set to 4 (verify_split_f32, followed
// by combine_splits where it splits), or -1 where nothing launched.
extern "C" int decode_verify_f32_fwd(int kv_int8, const void* q, const void* k, const void* v,
                                     const void* valid, const void* sk, const void* sv,
                                     const void* ks, const void* vs, const void* q_offsets,
                                     void* o, void* ws, int B, int Q, int H, int Hkv, int L,
                                     int D, int P, int rows_per_block, int splits_prefix,
                                     int splits_cache, float scale, void* stream, int* kernel) {
  *kernel = -1;
  if (B <= 0 || Q < 2 || Hkv <= 0 || H % Hkv != 0 || L < 0 || P < 0 || P + L <= 0 ||
      q_offsets == nullptr)
    return (int)cudaErrorInvalidValue;
  if (kv_int8 && L > 0 && (ks == nullptr || vs == nullptr)) return (int)cudaErrorInvalidValue;
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o) &&
        (P == 0 || (aligned16(sk) && aligned16(sv))) && (ws == nullptr || aligned16(ws))))
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(q),
               k,
               v,
               static_cast<const uint8_t*>(valid),
               static_cast<const float*>(P ? sk : nullptr),
               static_cast<const float*>(P ? sv : nullptr),
               static_cast<const float*>(ks),
               static_cast<const float*>(vs),
               static_cast<const int*>(q_offsets),
               static_cast<float*>(o),
               static_cast<float*>(ws),
               B, Q, H, Hkv, L, P, splits_prefix, splits_cache, scale,
               static_cast<cudaStream_t>(stream)};
  const cudaError_t err = dispatch(a, D, rows_per_block, kv_int8 != 0);
  if (err == cudaSuccess) *kernel = 4;
  return (int)err;
}
