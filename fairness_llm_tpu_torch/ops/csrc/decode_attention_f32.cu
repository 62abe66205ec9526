// Decode attention in float32, one query per row, for Hopper (sm_90a): the
// float32 one-query route of decode attention (K2 over a float cache, K2q
// over an int8 cache; decode_verify_f32.cu holds the float32 verify window),
// in a source of its own so that it builds in parallel with the others.
//
// Replaces: fairness_llm_tpu/ops/decode_attention.py, `decode_attention`
// (the Pallas TPU kernel), 3-D q -> `_kernel`, float cache and its
// `quant=True` branch. Same function: q [B,H,D] against the shared prefix
// k/v [P,Hkv,D] (always visible) followed by the row's cache k/v [B,L,Hkv,D]
// under valid [B,L], in one joint online softmax in f32; scale D^-0.5; head
// h reads kv head h / rep; the output is acc / max(l, 1e-30), so a row that
// sees no key comes out 0. With an int8 cache (scales ks/vs [B,L,Hkv] f32)
// the k-scale multiplies the score before the max, the normaliser l sums
// the unscaled p, and PV takes p * v-scale; the prefix stays float.
//
// What bounds it on the H100: ~4*D operations for every 2*2*D bytes of k/v,
// so the bytes of the cache and the prefix over 3.35 TB/s; at the study
// checkpoints' shapes (head width 32, 16 rows of 4 heads over 128 + 160
// keys) that is a fraction of a microsecond, below one launch's own time,
// so a call's time is its launches, its loads' latencies and the chain of
// work a block does in series.
//
// decode_split_f32, on scalar f32 FMAs. 3xTF32 on mma.sync was not taken:
// a call is a few tiles of work a block, bound by latency and the launches
// rather than by the FMAs, and the float32 gates want exact f32 products.
// The design follows decode_split_tc: the keys are split across blocks so
// that prefix splits plus cache splits fill one wave of the card's SMs (the
// wrapper's decode_splits_f32), each split a run of whole 32-key tiles of
// one kind; each split writes f32 partials (m in log2 units, l, acc), and
// combine_splits (combine_splits.cuh) folds them in split order (with one
// split the block writes the output itself). A block is one warp, so no
// warp idles on a kv head with fewer query rows than warps (rep is 1-2 for
// the study checkpoints) and none waits at a block barrier: its lanes stage
// their own tiles through a two-slot cp.async ring.
//
// A prefix block takes 8 of the B * rep query rows of one kv head, so each
// prefix tile is read B * rep / 8 times a kv head (4 at the study's batch of
// 16 and rep 2), not once a row. It runs them in the quad layout
// (attention_common.cuh's quad_tile): lane 4r + g holds row r's query and
// accumulator for a quarter of the columns, the scores are reduced and the
// weights gathered over the row's four lanes, 50 shuffles a tile where one
// key a lane takes 296 for eight rows.
//
// A cache block takes the rep rows of one (batch row, kv head), in chunks
// of RC = 1, 2, 4 or 8, over a run of that row's tiles. It first reads the
// valid bytes of its run into one mask word a tile: a tile with no valid
// slot is neither loaded nor computed, and a slot that is not valid is
// zero-filled instead of read. It takes one key a lane: the rows' dot
// products from the staged key row and the query rows in shared memory;
// P.V takes key j's weight from lane j by __shfl_sync and the v row from
// the ring slot, so P never goes through shared memory. A block computes
// all RC rows, those past its last on zero queries, so that no row loop
// branches: a warp-uniform break in an unrolled row loop serialises the
// rows.
//
// Scores are in log2 units (q scaled once by the softmax scale times
// log2(e)). The wrapper pads D to 32, 64, 128 or 256 and every row to a
// 16-byte boundary.

#include <type_traits>

#include "attention_common.cuh"
#include "combine_splits.cuh"

namespace {

using namespace attn;

constexpr int kBlockK = 32;        // keys per tile: one per lane
constexpr int kF32Slots = 2;       // ring slots a block: the next tile lands while one is computed
constexpr int kF32PrefixRows = 8;  // query rows a prefix block (the wrapper's F32_PREFIX_ROWS)

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// One staged k (or v) tile of 32 float rows, DW + 4 floats apart: an int8
// tile (DW + 16 bytes a row) fits its room.
__host__ __device__ constexpr size_t tile_bytes(int DW) {
  return align16(sizeof(float) * kBlockK * (DW + 4));
}

// A ring slot: the k tile and the v tile, then 32 k and 32 v scales (int8 cache).
__host__ __device__ constexpr size_t slot_bytes(int DW) {
  return 2 * tile_bytes(DW) + 2 * kBlockK * sizeof(float);
}

template <typename T>
struct Type {
  using type = T;
};
template <int N>
using Int = std::integral_constant<int, N>;

// One query per row over a float (kv_int8 = 0) or an int8 cache (kv_int8 =
// 1, scales ksc/vsc); see the note at the top of the file. DW: the head
// width. A block is one warp. Blocks [0, sp * Hkv * nrp) are prefix
// blocks: (prefix split, kv head hk, chunk of 8 of the B * rep query rows
// of hk, row r being head hk * rep + r % rep of batch row r / rep), nrp
// chunks a kv head. The rest are cache blocks: (cache split, batch row b,
// kv head hk, chunk of rc (1, 2, 4 or 8) of hk's rep rows in row b), nrc
// chunks. Splits are runs of whole tiles, as decode_split_tc numbers them;
// with sp + sc > 1 the block writes partials in combine_splits' layout (acc
// [sp + sc][B * H][DW], then (m, l)), else o. sl: the softmax scale times
// log2(e). The cache's type and rc are picked inside, so that the prefix
// path is built once a width.
template <int DW>
__global__ void __launch_bounds__(32)
decode_split_f32(const float* __restrict__ q, const void* __restrict__ kp,
                 const void* __restrict__ vp, const uint8_t* __restrict__ valid,
                 const float* __restrict__ sk, const float* __restrict__ sv,
                 const float* __restrict__ ksc, const float* __restrict__ vsc,
                 float* __restrict__ o, float* __restrict__ ws, int B, int H, int Hkv, int L,
                 int P, int sp, int sc, int kv_int8, int rc, float sl) {
  constexpr int RP = kF32PrefixRows, NCH = DW / 32, DP = DW / 4;
  constexpr int DS = DW + 4, DS8 = DW + 16;  // staged row strides: float, int8
  constexpr size_t tb = tile_bytes(DW), slot = slot_bytes(DW);
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + kF32Slots * slot);  // [8][DW]: cache blocks
  uint32_t* tmask =
      reinterpret_cast<uint32_t*>(smem + kF32Slots * slot + align16(sizeof(float) * RP * DW));
  const int lane = threadIdx.x;
  const int rep = H / Hkv;
  const int nrp = (B * rep + RP - 1) / RP, nrc = (rep + rc - 1) / rc;
  const int npre = sp * Hkv * nrp, bx = blockIdx.x;
  const bool pre = bx < npre;
  int hk, b = 0, split, r0;  // r0: the block's first row among those of its kind
  if (pre) {
    r0 = (bx % nrp) * RP;
    hk = (bx / nrp) % Hkv;
    split = bx / (nrp * Hkv);
  } else {
    const int i = bx - npre;
    r0 = (i % nrc) * rc;
    hk = (i / nrc) % Hkv;
    b = (i / (nrc * Hkv)) % B;
    split = sp + i / (nrc * Hkv * B);
  }
  const int nrows = pre ? min(RP, B * rep - r0) : min(rc, rep - r0);
  // The output row (b * H + head) of block row r < nrows.
  auto orow = [&](int r) -> long long {
    const int g = r0 + r;
    if (!pre) return (long long)b * H + hk * rep + g;
    const int bb = g / rep;
    return (long long)bb * H + hk * rep + (g - bb * rep);
  };

  // The block's run of tiles [t0, t1) of the prefix or of row b's cache.
  int t0, t1;
  if (pre) {
    const int ntp = (P + kBlockK - 1) / kBlockK, per = (ntp + sp - 1) / sp;
    t0 = split * per;
    t1 = min(t0 + per, ntp);
  } else {
    const int ntc = (L + kBlockK - 1) / kBlockK, per = (ntc + sc - 1) / sc;
    t0 = (split - sp) * per;
    t1 = min(t0 + per, ntc);
  }
  const int ntiles = max(t1 - t0, 0);
  const int nsplit = sp + sc;
  const long long nout = (long long)B * H;
  const long long rs = (long long)Hkv * DW;  // elements from one key row to the next

  if (pre) {
    // The prefix in the quad layout: lane 4r + g holds block row r's query
    // and accumulator for quad_tile's DP columns of lane g, from c0 = 4g.
    const float* kr = sk + (long long)hk * DW;
    const float* vr = sv + (long long)hk * DW;
    auto stage = [&](int t, int st) {
      unsigned char* dst = smem + st * slot;
      const int n0 = (t0 + t) * kBlockK;
      stage_rows<float>(reinterpret_cast<float*>(dst), kBlockK, DW, kr, [&](int j) -> const float* {
        return n0 + j < P ? kr + (n0 + j) * rs : nullptr;
      });
      stage_rows<float>(reinterpret_cast<float*>(dst + tb), kBlockK, DW, vr,
                        [&](int j) -> const float* {
                          return n0 + j < P ? vr + (n0 + j) * rs : nullptr;
                        });
    };
    if (ntiles > 0) stage(0, 0);
    cp_async_commit();
    const int r = lane / 4, c0 = (lane & 3) * 4;
    const bool live = r < nrows;
    float qr[DP], acc[DP];
    const float4* src = reinterpret_cast<const float4*>(q + (live ? orow(r) : 0) * DW + c0);
#pragma unroll
    for (int d4 = 0; d4 < DP / 4; ++d4) {
      const float4 x = live ? src[4 * d4] : make_float4(0.f, 0.f, 0.f, 0.f);
      qr[4 * d4] = x.x * sl;
      qr[4 * d4 + 1] = x.y * sl;
      qr[4 * d4 + 2] = x.z * sl;
      qr[4 * d4 + 3] = x.w * sl;
    }
#pragma unroll
    for (int d = 0; d < DP; ++d) acc[d] = 0.f;
    float m = kNegInf, l = 0.f;  // l: this lane's keys; summed over the quad at the end
    for (int t = 0; t < ntiles; ++t) {
      if (t + 1 < ntiles) stage(t + 1, (t + 1) % kF32Slots);
      cp_async_commit();
      cp_async_wait<1>();  // tile t landed; the next may still be in flight
      __syncwarp();
      const unsigned char* tile = smem + (t % kF32Slots) * slot;
      const int n0 = (t0 + t) * kBlockK;
      quad_tile<DP>(qr, reinterpret_cast<const float*>(tile),
                    reinterpret_cast<const float*>(tile + tb), DS,
                    [&](int j) { return n0 + j < P; }, m, l, acc);
      __syncwarp();  // every lane is done with this slot before it is staged again
    }
    cp_async_wait<0>();
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (!live) return;  // a row past the block's last: computed, never written
    const long long orr = orow(r);
    if (nsplit == 1) {
      const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
      for (int d = 0; d < DP; ++d) o[orr * DW + c0 + 16 * (d / 4) + d % 4] = acc[d] * inv;
    } else {
      const long long pr = split * nout + orr;
#pragma unroll
      for (int d = 0; d < DP; ++d) ws[pr * DW + c0 + 16 * (d / 4) + d % 4] = acc[d];
      if ((lane & 3) == 0)
        reinterpret_cast<float2*>(ws + nsplit * nout * DW)[pr] = make_float2(m, l);
    }
    return;
  }

  // A cache block over a float or an int8 cache (KT), RC rows.
  auto cache_block = [&](auto kt_tag, auto rc_tag) {
    using KT = typename decltype(kt_tag)::type;
    constexpr int RC = decltype(rc_tag)::value;
    constexpr bool QUANT = std::is_same<KT, int8_t>::value;
    const KT* k = static_cast<const KT*>(kp);
    const KT* v = static_cast<const KT*>(vp);
    // Its query rows, scaled into log2 units (zeros past the last): every
    // row's loads go out here and land in shared memory once the first
    // tile's copies are out too, so the loads' latencies overlap. Its valid
    // mask, one word a tile: the valid bytes of eight tiles are read before
    // their ballots.
    float qv[RC][NCH];
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      const long long base = r < nrows ? orow(r) * DW : -1;
#pragma unroll
      for (int c = 0; c < NCH; ++c) qv[r][c] = base >= 0 ? q[base + lane + 32 * c] * sl : 0.f;
    }
    const uint8_t* vrow = valid + (long long)b * L;
    for (int t = 0; t < ntiles; t += 8) {
      uint8_t vb[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int n = (t0 + t + u) * kBlockK + lane;
        vb[u] = t + u < ntiles && n < L ? vrow[n] : 0;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const uint32_t bits = __ballot_sync(0xffffffffu, vb[u] != 0);
        if (lane == 0 && t + u < ntiles) tmask[t + u] = bits;
      }
    }
    __syncwarp();

    const long long cbase = (long long)b * L * rs + (long long)hk * DW;
    const KT* kc = k + cbase;
    const KT* vc = v + cbase;
    // Run tile t into ring slot st. A slot that is not valid is zero-filled,
    // not read.
    auto stage = [&](int t, int st) {
      unsigned char* dst = smem + st * slot;
      const int n0 = (t0 + t) * kBlockK;
      const uint32_t vm = tmask[t];
      stage_rows<KT>(reinterpret_cast<KT*>(dst), kBlockK, DW, kc, [&](int j) -> const KT* {
        return (vm >> j) & 1u ? kc + (n0 + j) * rs : nullptr;
      });
      stage_rows<KT>(reinterpret_cast<KT*>(dst + tb), kBlockK, DW, vc, [&](int j) -> const KT* {
        return (vm >> j) & 1u ? vc + (n0 + j) * rs : nullptr;
      });
      if constexpr (QUANT) {
        float* scales = reinterpret_cast<float*>(dst + 2 * tb);  // k: 32, then v: 32
        const bool in = (vm >> lane) & 1u;
        const long long si = in ? ((long long)b * L + n0 + lane) * Hkv + hk : 0;
        cp_async4(scales + lane, ksc + si, in);
        cp_async4(scales + kBlockK + lane, vsc + si, in);
      }
    };
    // The next tile of the run from t on that has a valid slot.
    auto next_tile = [&](int t) {
      while (t < ntiles && tmask[t] == 0u) ++t;
      return t;
    };

    float m[RC], l[RC], acc[RC][NCH];  // l: this lane's keys; the warp sums it at the end
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) acc[r][c] = 0.f;
    }
    int cur = next_tile(0);
    if (cur < ntiles) stage(cur, 0);
    cp_async_commit();
#pragma unroll
    for (int r = 0; r < RC; ++r)
#pragma unroll
      for (int c = 0; c < NCH; ++c) qs[r * DW + lane + 32 * c] = qv[r][c];
    __syncwarp();
    for (int it = 0; cur < ntiles; ++it) {
      const int nxt = next_tile(cur + 1);
      if (nxt < ntiles) stage(nxt, (it + 1) % kF32Slots);
      cp_async_commit();
      cp_async_wait<1>();  // tile cur landed; the next may still be in flight
      __syncwarp();
      const unsigned char* tile = smem + (it % kF32Slots) * slot;
      const bool ok = ((tmask[cur] >> lane) & 1u) != 0u;  // the lane's slot is valid
      float s[RC];
#pragma unroll
      for (int r = 0; r < RC; ++r) s[r] = 0.f;
      float vs_lane = 1.f;
      strided_row_dots<KT, RC>(s, qs, reinterpret_cast<const KT*>(tile) + lane * (QUANT ? DS8 : DS),
                               DW, RC);
      if constexpr (QUANT) {
        const float* scales = reinterpret_cast<const float*>(tile + 2 * tb);
        const float ks_lane = scales[lane];
        vs_lane = scales[kBlockK + lane];
#pragma unroll
        for (int r = 0; r < RC; ++r) s[r] *= ks_lane;
      }
      // Online softmax in log2 units; s[r] becomes what P.V takes: p times
      // the v-scale over an int8 cache (the normaliser sums the unscaled p).
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        const float x = ok ? s[r] : kNegInf;
        const float mx = fmaxf(m[r], warp_max(x));
        const float alpha = exp2f(m[r] - mx);  // 1 while the row has seen no key
        const float p = ok ? exp2f(x - mx) : 0.f;
        l[r] = l[r] * alpha + p;
        m[r] = mx;
        s[r] = p * vs_lane;
#pragma unroll
        for (int c = 0; c < NCH; ++c) acc[r][c] *= alpha;
      }
      // acc += P.V: key j's weight from lane j by shuffle, the v row from the slot.
      const KT* vt = reinterpret_cast<const KT*>(tile + tb);
#pragma unroll 8
      for (int j = 0; j < kBlockK; ++j) {
        float vv[NCH];
#pragma unroll
        for (int c = 0; c < NCH; ++c) vv[c] = to_f(vt[j * (QUANT ? DS8 : DS) + lane + 32 * c]);
#pragma unroll
        for (int r = 0; r < RC; ++r) {
          const float pj = __shfl_sync(0xffffffffu, s[r], j);
#pragma unroll
          for (int c = 0; c < NCH; ++c) acc[r][c] += pj * vv[c];
        }
      }
      __syncwarp();  // every lane is done with this slot before it is staged again
      cur = nxt;
    }
    cp_async_wait<0>();

#pragma unroll
    for (int r = 0; r < RC; ++r) {
      const float lt = warp_sum(l[r]);
      if (r >= nrows) continue;  // a row past the block's last: computed, never written
      const long long orr = orow(r);
      if (nsplit == 1) {
        const float inv = 1.f / fmaxf(lt, 1e-30f);
#pragma unroll
        for (int c = 0; c < NCH; ++c) o[orr * DW + lane + 32 * c] = acc[r][c] * inv;
      } else {
        const long long pr = split * nout + orr;
#pragma unroll
        for (int c = 0; c < NCH; ++c) ws[pr * DW + lane + 32 * c] = acc[r][c];
        if (lane == 0)
          reinterpret_cast<float2*>(ws + nsplit * nout * DW)[pr] = make_float2(m[r], lt);
      }
    }
  };
  auto rows = [&](auto kt_tag) {
    if (rc == 1)
      cache_block(kt_tag, Int<1>{});
    else if (rc == 2)
      cache_block(kt_tag, Int<2>{});
    else if (rc == 4)
      cache_block(kt_tag, Int<4>{});
    else
      cache_block(kt_tag, Int<8>{});
  };
  if (kv_int8)
    rows(Type<int8_t>{});
  else
    rows(Type<float>{});
}

struct Args {
  const float* q;
  const void *k, *v;
  const uint8_t* valid;
  const float *sk, *sv, *ks, *vs;
  float *o, *ws;
  int B, H, Hkv, L, P, sp, sc;
  float scale;
  cudaStream_t stream;
};

template <int DW>
cudaError_t launch(const Args& a, bool kv_int8) {
  const int ntp = (a.P + kBlockK - 1) / kBlockK, ntc = (a.L + kBlockK - 1) / kBlockK;
  const int nsplit = a.sp + a.sc;
  if (a.sp < (ntp > 0) || a.sp > ntp || a.sc < (ntc > 0) || a.sc > ntc ||
      (nsplit > 1 && a.ws == nullptr))
    return cudaErrorInvalidValue;
  // A cache block's rows: the rep query rows of one (batch row, kv head), in
  // chunks of rc = 1, 2, 4 or 8 (the next power of two, at most 8).
  const int rep = a.H / a.Hkv;
  const int rc = rep <= 1 ? 1 : rep <= 2 ? 2 : rep <= 4 ? 4 : 8;
  const long long nrp = ((long long)a.B * rep + kF32PrefixRows - 1) / kF32PrefixRows;
  const long long nrc = (rep + rc - 1) / rc;
  const long long blocks = a.sp * a.Hkv * nrp + (long long)a.sc * a.B * a.Hkv * nrc;
  if (blocks > 0x7fffffffLL || (long long)a.B * rep > 0x7fffffffLL) return cudaErrorInvalidValue;
  // The ring, a cache block's query rows, and its masks (one word a tile of its run).
  const int run = a.sc > 0 ? (ntc + a.sc - 1) / a.sc : 0;
  const size_t smem = kF32Slots * slot_bytes(DW) + align16(sizeof(float) * kF32PrefixRows * DW) +
                      align16(sizeof(uint32_t) * run);
  auto kernel = decode_split_f32<DW>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, 32, smem, a.stream>>>(
      a.q, a.k, a.v, a.valid, a.sk, a.sv, a.ks, a.vs, a.o, a.ws, a.B, a.H, a.Hkv, a.L, a.P, a.sp,
      a.sc, kv_int8 ? 1 : 0, rc, a.scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  return launch_combine<float>(a.ws, a.o, nsplit, (long long)a.B * a.H, DW, a.stream);
}

cudaError_t dispatch(const Args& a, int D, bool kv_int8) {
  if (D == 32) return launch<32>(a, kv_int8);
  if (D == 64) return launch<64>(a, kv_int8);
  if (D == 128) return launch<128>(a, kv_int8);
  if (D == 256) return launch<256>(a, kv_int8);
  return cudaErrorInvalidValue;
}

}  // namespace

// decode_attention_fwd's arguments (decode_attention.cu), for float32 q, the
// prefix and a float cache (dtype 0) with one query per row (Q = 1;
// q_offsets ignored); kv_int8: the cache k/v are int8 with scales ks/vs
// [B,L,Hkv] f32. D of 32, 64, 128 or 256; q, k, v, the prefix and ws
// 16-byte aligned. The keys are walked in splits_prefix + splits_cache
// splits (1 <= splits_prefix <= ceil(P / 32) where P > 0, else 0; the same
// for splits_cache and L), with ws holding (splits_prefix + splits_cache) *
// B * H * (D + 2) floats where there is more than one split. Anything else
// returns cudaErrorInvalidValue; otherwise the CUDA error code of the
// launch. *kernel is set to 3 (decode_split_f32, followed by combine_splits
// where it splits), or -1 where nothing launched.
extern "C" int decode_attention_f32_fwd(int dtype, int kv_int8, const void* q, const void* k,
                                        const void* v, const void* valid, const void* sk,
                                        const void* sv, const void* ks, const void* vs,
                                        const void* q_offsets, void* o, void* ws, int B, int Q,
                                        int H, int Hkv, int L, int D, int P, int splits_prefix,
                                        int splits_cache, float scale, void* stream,
                                        int* kernel) {
  (void)q_offsets;
  *kernel = -1;
  if (dtype != 0 || Q != 1 || B <= 0 || Hkv <= 0 || H % Hkv != 0 || L < 0 || P < 0 ||
      P + L <= 0)
    return (int)cudaErrorInvalidValue;
  if (kv_int8 && L > 0 && (ks == nullptr || vs == nullptr)) return (int)cudaErrorInvalidValue;
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o) &&
        (P == 0 || (aligned16(sk) && aligned16(sv))) && (ws == nullptr || aligned16(ws))))
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(q),  k, v, static_cast<const uint8_t*>(valid),
               static_cast<const float*>(P ? sk : nullptr),
               static_cast<const float*>(P ? sv : nullptr), static_cast<const float*>(ks),
               static_cast<const float*>(vs), static_cast<float*>(o), static_cast<float*>(ws),
               B, H, Hkv, L, P, splits_prefix, splits_cache, scale,
               static_cast<cudaStream_t>(stream)};
  const cudaError_t err = dispatch(a, D, kv_int8 != 0);
  if (err == cudaSuccess) *kernel = 3;
  return (int)err;
}
