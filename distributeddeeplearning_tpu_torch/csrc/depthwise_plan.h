// How the depthwise kernels of depthwise.cu cut a call, from shapes alone:
// the staged tile's constants, the TMA kernels' strip rule and the TMA
// wgrad's whole plan. Plain C++ (depthwise.cu includes it; depthwise_plan.cpp
// builds it alone for the host), so the one planner the card runs is also
// the one ops/depthwise.wgrad_plan reads on a machine without a card.
#pragma once

#ifdef __CUDACC__
#define DW_HD __host__ __device__
#else
#define DW_HD
#endif

// Build switches of the TMA wgrad (scripts/depthwise_ablation.py):
// DW_WGRAD_RING_EXTRA its ring's slots beyond k and DW_WGRAD_VEC a
// thread's channels (0: the plan's choice; 1, 2 or 4).
#ifndef DW_WGRAD_RING_EXTRA
#define DW_WGRAD_RING_EXTRA 0
#endif
#ifndef DW_WGRAD_VEC
#define DW_WGRAD_VEC 0
#endif

namespace {

constexpr int kCB = 32;  // the staged tile's channels a block: one warp's lanes
constexpr int kTH = 8;   // its output rows: one warp each
constexpr int kTW = 12;  // its output columns a thread

constexpr int kMaxSmem = 232448;      // a block's dynamic shared memory at most
constexpr int kWgMaxConsumers = 256;  // the TMA wgrad's compute threads a block at most

struct Shape {
  int B, H, W, C;
};

DW_HD constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }
DW_HD constexpr int align128(int x) { return (x + 127) & ~127; }
DW_HD constexpr int imax(int a, int b) { return a > b ? a : b; }
DW_HD constexpr int imin(int a, int b) { return a < b ? a : b; }

// Output rows a strip: of the strip counts that leave at least 4 rows a
// strip, the one whose items fill the card's block slots best (least
// waves x (2 rows + halo), a halo row costing its load only).
inline int strip_rows(int H, int K, long long tiles, long long slots) {
  int best = H;
  long long best_cost = -1;
  for (int n = 1; n <= imax(1, H / 4); ++n) {
    const int rows = ceil_div(H, n), strips = ceil_div(H, rows);
    const long long cost = (tiles * strips + slots - 1) / slots * (2 * rows + K - 1);
    if (best_cost < 0 || cost < best_cost) best_cost = cost, best = rows;
  }
  return best;
}

// How a TMA-wgrad launch is cut: an item is (image, strip of `rows` output
// rows, tile of `tw` output columns, slice of `cs` channels), channel slice
// fastest, then column tile, strip, image; a compute thread owns `run`
// columns x `vec` channels of the tile; the ring holds `ring` slots, each a
// padded x row of `box_w` = tw + k - 1 columns and a dy row of tw columns
// (cs channels each). One partial row [k*k][C] per (image, strip, column
// tile).
struct WgPlan {
  int cs, cslices, tw, ctiles, rows, strips, box_w, ring, run, vec, consumers, smem;
};

DW_HD inline int wg_xrow_bytes(const WgPlan& p, int elem) { return align128(p.box_w * p.cs * elem); }
DW_HD inline int wg_slot_bytes(const WgPlan& p, int elem) {
  return wg_xrow_bytes(p, elem) + align128(p.tw * p.cs * elem);
}
// Shared memory: the full and empty mbarriers, then the ring (after the
// strip, the same bytes hold the block's per-thread sums for the
// reduction: [tw / run][k*k][cs] f32).
DW_HD inline int wg_ring_off(const WgPlan& p) { return align128(16 * p.ring); }
inline int wg_smem(const WgPlan& p, int K, int elem) {
  return wg_ring_off(p) + imax(p.ring * wg_slot_bytes(p, elem), p.tw / p.run * K * K * p.cs * 4);
}

// A thread's channels: k*k*V f32 sums in registers, at most 50.
DW_HD constexpr int wgrad_vec(int K) {
  return DW_WGRAD_VEC ? DW_WGRAD_VEC : (K == 3 ? 4 : K == 5 ? 2 : 1);
}

// Every field of the TMA wgrad's plan but its strips (k in {3, 5, 7}, C a
// multiple of the 16-byte vector); false where no plan fits shared memory.
// A thread owns 4 columns on rows of at most 12, else 8. The channel slice
// is the fewest slices that divide C into multiples of the 16-byte vector
// (and V) where one of at most twice the least count does, so no lane
// idles at C = 24 or 48; a column tile is as many runs as 256 threads and
// a 256-column box hold, evened out. Where two blocks of k + 1 ring slots
// would not fit an SM, the channel slices halve first (no bytes added),
// then the column tiles narrow (each adds its halo's k - 1 columns). The
// ring holds k + 2 slots, fewer if two blocks an SM would not fit.
inline bool wg_geometry(WgPlan& p, const Shape& s, int K, int elem) {
  p = WgPlan{};
  const int V = wgrad_vec(K), unit = imax(V, 16 / elem);
  p.vec = V;
  p.run = s.W <= 12 ? 4 : 8;
  const int runs = ceil_div(s.W, p.run);
  const int cs_max = imax(unit, imin(256, kWgMaxConsumers / runs * V) / unit * unit);
  const int least = ceil_div(s.C, cs_max);
  p.cslices = least;
  for (int n = least; n <= 2 * least; ++n)
    if (s.C % n == 0 && s.C / n % unit == 0) {
      p.cslices = n;
      break;
    }
  int ctiles = 1;
  for (;;) {
    p.cs = ceil_div(ceil_div(s.C, p.cslices), unit) * unit;
    const int vecs = p.cs / V;
    const int tile_max = imax(1, imin(kWgMaxConsumers / vecs, (256 - K + 1) / p.run));
    const int tile_runs = ceil_div(runs, imax(ctiles, ceil_div(runs, tile_max)));
    p.ctiles = ceil_div(runs, tile_runs);
    p.tw = tile_runs * p.run;
    p.box_w = p.tw + K - 1;
    p.consumers = ceil_div(tile_runs * vecs, 32) * 32;
    p.ring = K + 1;
    if (wg_smem(p, K, elem) <= kMaxSmem / 2) break;
    if (p.cs > unit) {
      p.cslices *= 2;
    } else if (tile_runs > 1) {
      ctiles = p.ctiles + 1;
    } else {
      break;
    }
  }
  p.ring = K + (DW_WGRAD_RING_EXTRA > 0 ? DW_WGRAD_RING_EXTRA : 2);
  while (p.ring > K + 1 && wg_smem(p, K, elem) > kMaxSmem / 2) --p.ring;
  p.smem = wg_smem(p, K, elem);
  return p.smem <= kMaxSmem;
}

// The strips of a plan whose kernel runs `per_sm` blocks an SM.
template <typename Plan>
void plan_strips(Plan& p, const Shape& s, int K, int sm_count, int per_sm) {
  p.rows = strip_rows(s.H, K, (long long)s.B * p.ctiles * p.cslices, (long long)sm_count * per_sm);
  p.strips = ceil_div(s.H, p.rows);
}

constexpr int kWgPlanInts = 14;

// The wgrad's plan as ints (ops/depthwise.wgrad_plan's fields): WgPlan's
// fields in order (TMA path; zeros else), then the partial rows the
// blocks write and the items (blocks) of the partials kernel. path: 0 =
// TMA (`p` its plan), 1 = staged tile (B x ceil(W / 12) partial rows), 2 =
// direct (none).
inline void wgrad_plan_ints(const WgPlan* p, const Shape& s, int path, int* out) {
  for (int i = 0; i < kWgPlanInts; ++i) out[i] = 0;
  if (path == 0) {
    const int f[12] = {p->cs,   p->cslices, p->tw,  p->ctiles, p->rows,      p->strips,
                       p->box_w, p->ring,    p->run, p->vec,    p->consumers, p->smem};
    for (int i = 0; i < 12; ++i) out[i] = f[i];
    out[12] = s.B * p->strips * p->ctiles;
    out[13] = out[12] * p->cslices;
  } else if (path == 1) {
    out[12] = s.B * ceil_div(s.W, kTW);
    out[13] = out[12] * ceil_div(s.C, kCB);
  }
}

}  // namespace
