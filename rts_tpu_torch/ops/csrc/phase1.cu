// Phase 1 of the clustered traversal for NVIDIA Hopper (sm_90a): per ray
// tile, the near-to-far list of clusters that some ray of the tile
// overlaps, the per-sub-block overlap bits, the entry table and the
// overflow flag.
//
// Replaces no Pallas kernel: phase 1 is plain XLA in rts_tpu
// (rts_tpu/ops/cluster_trace.py:_tile_candidates), ported operation for
// operation to PyTorch as rts_tpu_torch/ops/cluster_trace.py:
// _tile_candidates, which stays as the CPU path and as this kernel's
// bit-exact oracle.  It was added because the card's profile asked for it
// (PERF.md section 5): on the terrain cell the plain version issued ~3,900
// operators and ~26 ms of elementwise device work a pulse, each level a
// chain of ~45 passes over a dense [tiles, rays, boxes] tensor of 80-123
// MB.
//
// What it computes, with _tile_candidates' names:
//   level 0 (when s >= _P1_L0_MIN_S): every ray against the s0 boxes of
//     runs of f0 supergroup boxes; a tile admits k0 of them;
//   level 1: every ray against the supergroup boxes (runs of `fanout`
//     cluster boxes): all s of them, or the k0 * f0 members of the tile's
//     admitted level-0 boxes; a tile admits ks of them.  Admission is
//     _top_k_indices(overlap * (n - index), k): the overlapped boxes in
//     ascending index order, then the lowest-indexed others;
//   level 2: every ray against the kf = ks * fanout member clusters of
//     the admitted supergroups (indices clamped to s * fanout - 1), giving
//     per member slot the sub-blocks that overlap it (bits) and the least
//     entry max(tn, 0) over the tile's rays; the overlapped slots sorted
//     stably by entry (ties toward the lower slot), the first k_max kept;
//     the entry floored to 1/16 m (min(e, 8e5) * 16); the mask order
//     (sort key (bits << 12) | position); padding slots past the count
//     (the last valid candidate, bits 0, entry 2**30); meta = (count
//     clamped to the list, overflow of any level).
//
// Design.  A pre-pass (phase1_boxes_kernel, one thread a box) builds the
// call's supergroup and level-0 boxes, pad_inf and run_boxes, into a small
// scratch.  Then one block per ray tile, one thread per ray
// (phase1_kernel): a thread loads its ray once (28 bytes) and keeps it in
// registers; the block walks the boxes of each level, every thread runs
// the slab test of its ray, and a warp vote (levels 0 and 1) or a warp
// OR and min reduction (level 2: the sub-block bits and the entry,
// min'ed as the float's bits: entries are >= 0 or +inf, so the minimum is
// exact in any order) with one shared-memory atomic per warp folds the
// rays into the tile's per-box state; each level's boxes are staged in
// shared memory before its walk.  Admission is one warp scanning the
// flags with ballots; the near-to-far order is a rank by counting, (entry,
// slot) pairs compared in shared memory.  So the [tiles, rays, boxes]
// level tensors never exist: what leaves the block is the tile's lists.
//
// What bounds it on this card: the slab tests' FP32 operations (per ray
// and box, 6 subtracts, 6 multiplies and 12 minima and maxima), with the
// rays read once and the boxes read by every block from the L2 (the
// call's supergroup boxes, a few KB, and its cluster boxes).  At the
// terrain cell's heavy calls that is 250,368 rays x (123 + 96 + 80) boxes.
//
// Numerics: built with --fmad=false (the traversal's flags) and IEEE
// reciprocals (__frcp_rn, bit-equal to 1.0f / x, as torch.reciprocal on
// the card), every product and sum rounded on its own, in the plain
// version's operation order.  The minima and maxima propagate NaN, as
// torch.minimum / torch.maximum / amin / amax do (fminf / fmaxf do not):
// NaN arises where a denormal direction component meets an origin on a box
// face.  An entry of -0.0 is stored as +0.0: no output can tell them apart
// (entries are compared, floored to integers, or sorted, where the two are
// equal).

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 3.0e38f;          // _BIG
constexpr unsigned kInfBits = 0x7f800000u;  // +inf as float bits
constexpr int kEntPad = 1 << 30;         // _ENT_PAD

struct P1 {
  const float* o;     // [3, lanes] ray origins, components-major
  const float* d;     // [3, lanes] directions (zero = dead lane)
  const float* tmin;  // [lanes]
  const float* mn;    // [c, 3] cluster boxes
  const float* mx;
  float* boxes;       // [n_s + s0, 6] scratch: supergroup boxes, then level-0 boxes (mn, mx)
  int* cand;          // [tiles, k_max]
  int* meta;          // [tiles, 2]
  int* bits;          // [tiles, k_max]
  int* ent;           // [tiles, k_max]
  int lanes, ray_tile, sub_tiles, k_max;
  int c, fanout, s, n_s, ks;  // n_s supergroup rows: s0 * f0 with level 0, else s
  int f0, s0, k0;             // level 0; s0 == 0: off
  int kf, k_eff, mask_order;
};

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// Supergroup box r: run_boxes over pad_inf(mn, s * fanout), and pad_inf's
// +inf rows past s (the level-0 padding).
__device__ void supergroup_box(const P1& p, int r, float* lo, float* hi) {
  if (r >= p.s) {
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) lo[ax] = hi[ax] = __int_as_float(kInfBits);
    return;
  }
  for (int q = 0; q < p.fanout; ++q) {
    const int i = r * p.fanout + q;
    float a[3], b[3];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      a[ax] = i < p.c ? p.mn[3 * i + ax] : __int_as_float(kInfBits);
      b[ax] = i < p.c ? p.mx[3 * i + ax] : __int_as_float(kInfBits);
    }
    const bool fin = isfinite(a[0]) && isfinite(b[0]);
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const float va = fin ? a[ax] : kBig, vb = fin ? b[ax] : -kBig;
      lo[ax] = q == 0 ? va : nan_min(lo[ax], va);
      hi[ax] = q == 0 ? vb : nan_max(hi[ax], vb);
    }
  }
  if (lo[0] > hi[0]) {
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) lo[ax] = hi[ax] = __int_as_float(kInfBits);
  }
}

// One thread a box: rows [0, n_s) the supergroup boxes, rows [n_s, n_s +
// s0) the level-0 boxes (runs of f0 supergroup rows, each kept where its
// min x is finite).
__global__ void phase1_boxes_kernel(P1 p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float lo[3], hi[3];
  if (i < p.n_s) {
    supergroup_box(p, i, lo, hi);
  } else if (i < p.n_s + p.s0) {
    const int z = i - p.n_s;
    for (int q = 0; q < p.f0; ++q) {
      float a[3], b[3];
      supergroup_box(p, z * p.f0 + q, a, b);
      const bool fin = isfinite(a[0]);
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        const float va = fin ? a[ax] : kBig, vb = fin ? b[ax] : -kBig;
        lo[ax] = q == 0 ? va : nan_min(lo[ax], va);
        hi[ax] = q == 0 ? vb : nan_max(hi[ax], vb);
      }
    }
    if (lo[0] > hi[0]) {
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) lo[ax] = hi[ax] = __int_as_float(kInfBits);
    }
  } else {
    return;
  }
  float* out = p.boxes + (size_t)i * 6;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    out[ax] = lo[ax];
    out[3 + ax] = hi[ax];
  }
}

struct Ray {
  float o[3], d[3], inv[3];
  float tmin;
  bool alive;
};

// batch_slab for one ray and one box: whether it overlaps, and its entry
// max(tn, 0) (+inf where it does not).
__device__ __forceinline__ bool slab(const Ray& r, const float* bmn, const float* bmx,
                                     float& entry) {
  float tn = -kBig, tf = kBig;
  bool box_ok = true;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float t1 = __fmul_rn(__fsub_rn(bmn[ax], r.o[ax]), r.inv[ax]);
    const float t2 = __fmul_rn(__fsub_rn(bmx[ax], r.o[ax]), r.inv[ax]);
    float lo = nan_min(t1, t2), hi = nan_max(t1, t2);
    if (r.d[ax] == 0.f) {
      const bool inside = (r.o[ax] >= bmn[ax]) && (r.o[ax] <= bmx[ax]);
      lo = inside ? -kBig : kBig;
      hi = inside ? kBig : -kBig;
    }
    tn = nan_max(tn, lo);
    tf = nan_min(tf, hi);
    box_ok = box_ok && isfinite(bmn[ax]) && isfinite(bmx[ax]) && bmn[ax] <= bmx[ax];
  }
  const bool ov = (tf >= tn) && (tf >= r.tmin) && r.alive && box_ok;
  entry = ov ? (tn > 0.f ? tn : 0.f) : __int_as_float(kInfBits);
  return ov;
}

// Called by one whole warp: the first k indices of [0, n) in admission
// order (flagged ascending, then the others ascending) into list; returns
// how many are flagged.
__device__ int admit(const int* flag, int n, int k, int* list) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int total = 0;
  for (int b = 0; b < n; b += 32) total += __popc(__ballot_sync(~0u, b + lane < n && flag[b + lane]));
  int over = 0, rest = 0;
  for (int b = 0; b < n; b += 32) {
    const int i = b + lane;
    const bool in = i < n, f = in && flag[i];
    const unsigned mf = __ballot_sync(~0u, f), mr = __ballot_sync(~0u, in && !f);
    if (in) {
      const int r = f ? over + __popc(mf & below) : total + rest + __popc(mr & below);
      if (r < k) list[r] = i;
    }
    over += __popc(mf);
    rest += __popc(mr);
  }
  return total;
}

// One block per ray tile, one thread per ray (blockDim = ray_tile rounded
// up to whole warps; the extra lanes hold dead rays).
__global__ void __launch_bounds__(1024) phase1_kernel(P1 p) {
  extern __shared__ int sm[];
  __shared__ int s_l0_over, s_over, s_count, s_last;
  const int tile = blockIdx.x, t = threadIdx.x, nt = blockDim.x, lane = t & 31;
  const bool level0 = p.s0 > 0;
  const int nsl = p.k0 * p.f0;
  const int n1 = level0 ? nsl : p.s;
  // layout: the level's boxes being tested (mn, mx), flags of the level-0
  // boxes, the admitted level-0 boxes, flags of the level-1 boxes, the
  // admitted level-1 positions, each member slot's bits and entry, the
  // near-to-far list's first k_eff (cluster, bits, entry); its size, the
  // launch's smem_bytes, is counted once, in cluster_trace.py:phase1_shape
  float* sbox = (float*)sm;
  int* flag0 = sm + 6 * max(max(p.s0, n1), p.kf);
  int* list0 = flag0 + p.s0;
  int* flag1 = list0 + p.k0;
  int* list1 = flag1 + n1;
  unsigned* sbits = (unsigned*)(list1 + p.ks);
  unsigned* sent = sbits + p.kf;
  int* l_order = (int*)(sent + p.kf);
  int* l_bits = l_order + p.k_eff;
  int* l_ent = l_bits + p.k_eff;

  for (int i = t; i < p.s0; i += nt) flag0[i] = 0;
  for (int i = t; i < n1; i += nt) flag1[i] = 0;
  for (int i = t; i < p.kf; i += nt) {
    sbits[i] = 0u;
    sent[i] = kInfBits;
  }
  if (t == 0) {
    s_l0_over = 0;
    s_count = 0;
  }
  Ray r;
  r.alive = false;
  r.tmin = 0.f;
  const size_t lane_id = (size_t)tile * p.ray_tile + t;
  const bool real = t < p.ray_tile;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    r.o[ax] = real ? p.o[(size_t)ax * p.lanes + lane_id] : 0.f;
    r.d[ax] = real ? p.d[(size_t)ax * p.lanes + lane_id] : 0.f;
    r.inv[ax] = __frcp_rn(r.d[ax] == 0.f ? 1.f : r.d[ax]);
  }
  if (real) {
    r.tmin = p.tmin[lane_id];
    r.alive = __fadd_rn(__fadd_rn(__fmul_rn(r.d[0], r.d[0]), __fmul_rn(r.d[1], r.d[1])),
                        __fmul_rn(r.d[2], r.d[2])) > 0.f;
  }
  __syncthreads();

  // each level's boxes are staged in shared memory first: every thread
  // reads every box, and a global load a box would set each step's latency
  float e;
  if (level0) {
    for (int i = t; i < 6 * p.s0; i += nt) sbox[i] = p.boxes[(size_t)p.n_s * 6 + i];
    __syncthreads();
    for (int b = 0; b < p.s0; ++b) {
      const bool ov = slab(r, sbox + 6 * b, sbox + 6 * b + 3, e);
      if (__any_sync(~0u, ov) && lane == 0) flag0[b] = 1;
    }
    __syncthreads();
    if (t < 32) {
      const int n = admit(flag0, p.s0, p.k0, list0);
      if (t == 0) s_l0_over = n > p.k0;
    }
    __syncthreads();
  }
  // the level-1 box at position j: a supergroup row (with level 0, member
  // j % f0 of the admitted level-0 box j / f0)
  auto row1 = [&](int j) { return level0 ? list0[j / p.f0] * p.f0 + j % p.f0 : j; };
  for (int i = t; i < 6 * n1; i += nt) sbox[i] = p.boxes[(size_t)row1(i / 6) * 6 + i % 6];
  __syncthreads();
  for (int j = 0; j < n1; ++j) {
    const bool ov = slab(r, sbox + 6 * j, sbox + 6 * j + 3, e);
    if (__any_sync(~0u, ov) && lane == 0) flag1[j] = 1;
  }
  __syncthreads();
  if (t < 32) {
    const int n = admit(flag1, n1, p.ks, list1);
    if (t == 0) s_over = s_l0_over || n > p.ks;
  }
  __syncthreads();

  // level 2: member slot j is member j % fanout of the admitted supergroup
  // j / fanout
  const int c_last = p.s * p.fanout - 1;
  auto member = [&](int j) { return min(row1(list1[j / p.fanout]) * p.fanout + j % p.fanout, c_last); };
  const int rs = p.ray_tile / p.sub_tiles;
  const unsigned my_bit = real ? 1u << (t / rs) : 0u;
  for (int i = t; i < 6 * p.kf; i += nt) {
    const int m = member(i / 6), k = i % 6;
    sbox[i] = m >= p.c ? __int_as_float(kInfBits) : k < 3 ? p.mn[3 * m + k] : p.mx[3 * m + k - 3];
  }
  __syncthreads();
  for (int j = 0; j < p.kf; ++j) {
    const bool ov = slab(r, sbox + 6 * j, sbox + 6 * j + 3, e);
    const unsigned wb = __reduce_or_sync(~0u, ov ? my_bit : 0u);
    if (wb) {
      const unsigned we = __reduce_min_sync(~0u, __float_as_uint(e));
      if (lane == 0) {
        atomicOr(&sbits[j], wb);
        atomicMin(&sent[j], we);
      }
    }
  }
  __syncthreads();

  // the overlapped slots' near-to-far ranks: by (entry, slot); the others
  // hold +inf, above every overlapped slot's entry
  int local = 0;
  for (int j = t; j < p.kf; j += nt) {
    if (sbits[j] == 0u) continue;
    ++local;
    const unsigned ej = sent[j];
    int rank = 0;
    for (int i = 0; i < p.kf; ++i) {
      const unsigned ei = sent[i];
      rank += (ei < ej) | ((ei == ej) & (i < j));
    }
    if (rank < p.k_eff) {
      l_order[rank] = member(j);
      l_bits[rank] = (int)sbits[j];
      l_ent[rank] = (int)floorf(__fmul_rn(fminf(__uint_as_float(ej), 8.0e5f), 16.0f));
    }
  }
  if (local) atomicAdd(&s_count, local);
  __syncthreads();
  const int count = s_count;
  const int cc = min(count, p.k_eff);
  const size_t row = (size_t)tile * p.k_max;
  for (int q = t; q < cc; q += nt) {
    int dst = q;
    if (p.mask_order) {
      const int key = (l_bits[q] << 12) | q;
      dst = 0;
      for (int i = 0; i < cc; ++i) {
        const int ki = (l_bits[i] << 12) | i;
        dst += (ki < key) | ((ki == key) & (i < q));
      }
    }
    p.cand[row + dst] = l_order[q];
    p.bits[row + dst] = l_bits[q];
    p.ent[row + dst] = l_ent[q];
    if (dst == cc - 1) s_last = l_order[q];
  }
  __syncthreads();
  for (int q = cc + t; q < p.k_max; q += nt) {
    p.cand[row + q] = cc > 0 ? s_last : 0;
    p.bits[row + q] = 0;
    p.ent[row + q] = kEntPad;
  }
  if (t == 0) {
    p.meta[2 * tile] = cc;
    p.meta[2 * tile + 1] = (int)(s_over || count > p.k_eff);
  }
}

}  // namespace

// Launch the box pre-pass and phase1_kernel on `stream` (PyTorch's current
// stream) and return the first CUDA error.  boxes: (n_s + s0) * 6 floats of
// scratch, written before they are read.
extern "C" int phase1_launch(
    const float* o, const float* d, const float* tmin, const float* mn, const float* mx,
    float* boxes, int* cand, int* meta, int* bits, int* ent,
    int tiles, int ray_tile, int sub_tiles, int k_max, int c, int fanout, int s, int n_s, int ks,
    int f0, int s0, int k0, int kf, int k_eff, int mask_order, int smem_bytes, void* stream) {
  P1 p{o, d, tmin, mn, mx, boxes, cand, meta, bits, ent,
       tiles * ray_tile, ray_tile, sub_tiles, k_max, c, fanout, s, n_s, ks,
       f0, s0, k0, kf, k_eff, mask_order};
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = n_s + s0;
  phase1_boxes_kernel<<<(rows + 127) / 128, 128, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = (ray_tile + 31) / 32 * 32;
  phase1_kernel<<<tiles, threads, smem_bytes, st>>>(p);
  return (int)cudaGetLastError();
}
