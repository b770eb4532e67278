// How the fused-bottleneck kernel of fused_block.cu cuts a call, from
// shapes alone: the column panel, the K box, the ring's depth, the
// persistent grid, each block's walk over the (row tile, column panel)
// items and the fixed-order merge of the statistics. Plain C++
// (fused_block.cu includes it; fused_block_plan.cpp builds it alone for the
// host), so the one planner the card runs is also the one
// ops/fused_block.plan reads on a machine without a card.
#pragma once

#ifdef __CUDACC__
#define FB_HD __host__ __device__
#else
#define FB_HD
#endif

// Build switches (scripts/fused_block_ablation.py): FB_STAGES the ring's
// depth (0: the deepest of at most 6 that fits), FB_PANEL the widest
// column panel allowed (0: 256), FB_ONE_LEVEL_MERGE = 1 one merge group a panel
// (the last block of the panel sums every block's row). None changes a
// result but the order of the statistics' sums, which the plan's
// stat_depth follows.
#ifndef FB_STAGES
#define FB_STAGES 0
#endif
#ifndef FB_PANEL
#define FB_PANEL 0
#endif
#ifndef FB_ONE_LEVEL_MERGE
#define FB_ONE_LEVEL_MERGE 0
#endif

namespace {

constexpr int kFbRows = 128;        // rows of y an item: two consumer warpgroups of 64
constexpr int kFbBoxK = 64;         // K columns a ring stage (one 128-byte swizzled row)
constexpr int kFbMaxStages = 6;
constexpr int kFbMaxSmem = 232448;  // a block's dynamic shared memory at most
constexpr int kFbPanelBytes = 64 * 128;  // 64 rows x 64 bf16 of staged y: one store box

FB_HD constexpr int fb_cdiv(int a, int b) { return (a + b - 1) / b; }

struct FbPlan {
  int bn;                // columns of y an item (the w panel): 256, 128 or 64
  int panels;            // N / bn
  int box_k;             // K columns a stage
  int kblocks;           // stages an item: ceil(K / box_k), the last zero-filled past K
  int stages;            // the ring's depth
  int row_tiles;         // ceil(M / 128)
  int items;             // row_tiles * panels
  int grid;              // blocks: blocks_per_panel * panels
  int blocks_per_panel;  // blocks that share a panel; block b takes panel b % panels
  int items_per_block;   // at most: row tiles b / panels, + blocks_per_panel, ...
  int group;             // blocks a merge group (the last of a group sums its rows)
  int groups;            // merge groups a panel (the last group's merger sums them)
  int transforms;        // prologue applications a element of a (0 without the prologue)
  int stat_depth;        // terms a column's sums pass through, at most (see fb_plan)
  int smem;              // dynamic shared memory a block
  int part_floats;       // scratch: grid x 2 x bn block rows, panels x groups x 2 x bn group rows
  int counters;          // zero int32 counters: panels x (groups + 1)
  int per_sm;            // blocks an SM the grid was sized for
};

// Shared memory (1024-byte aligned): the ring's stages (a's 128 x 64 box
// and w's bn x 64 box each), the staged y (two 64 x 64 boxes a consumer
// warpgroup), the folded affine (scale and shift for every padded K
// column), the ring's mbarriers and a flag.
FB_HD constexpr int fb_stage_bytes(int bn) { return kFbRows * 128 + bn * 128; }
constexpr int kFbYBytes = 2 * 2 * kFbPanelBytes;
FB_HD constexpr int fb_affine_bytes(int kblocks, int bn_relu) {
  return bn_relu ? 2 * kblocks * kFbBoxK * 4 : 0;
}
FB_HD constexpr int fb_smem(int bn, int stages, int kblocks, int bn_relu) {
  return stages * fb_stage_bytes(bn) + kFbYBytes + fb_affine_bytes(kblocks, bn_relu) +
         16 * stages + 16;
}

// A consumer thread's statistics: the column pair 2 lane, 2 lane + 1 of
// each 64-column box of its panel, over its warp's 16 rows of each item.
constexpr int kFbStatRows = 16;
constexpr int kFbStatParts = 8;  // warps of the two consumer warpgroups

// The cost model the panel width is chosen by, in microseconds, per SM:
// an item takes the largest of its products at 70 % of an SM's share of
// 989 TFLOP/s, its HBM bytes (a's rows once for all panels, y) at an
// SM's share of 3.35 TB/s, and its stages' bytes (a's and w's boxes) at
// 70 GB/s of L2 (the rate ops/fused_grads.py's cost model is fitted to),
// plus 0.5 for its epilogue; a block takes items_per_block of them.
constexpr double kFbSmFlopsUs = 0.7 * 989e6 / 132;
constexpr double kFbSmHbmBytesUs = 3.35e6 / 132;
constexpr double kFbSmL2BytesUs = 70e3;
constexpr double kFbItemUs = 0.5;

// The grid of a plan whose panel is set: as many blocks as `per_sm`
// blocks an SM on `sm_count` SMs hold, rounded down to a multiple of the
// panels (a block keeps one panel, so its w panel and its statistics'
// columns stay fixed, and the blocks of one row tile run side by side,
// reading a's rows from L2 after the first), at least one block a panel,
// at most one a row tile; and the model's cost of it.
inline double fb_grid(FbPlan& p, int M, int K, int N, int sm_count, int per_sm) {
  p.panels = N / p.bn;
  p.row_tiles = fb_cdiv(M, kFbRows);
  p.items = p.row_tiles * p.panels;
  int bpp = sm_count * per_sm / p.panels;
  if (bpp < 1) bpp = 1;
  if (bpp > p.row_tiles) bpp = p.row_tiles;
  p.blocks_per_panel = bpp;
  p.grid = bpp * p.panels;
  p.items_per_block = fb_cdiv(p.row_tiles, bpp);
  const double flops = 2.0 * kFbRows * p.bn * K;
  const double hbm = 2.0 * kFbRows * ((double)K / p.panels + p.bn);
  const double l2 = 2.0 * p.kblocks * kFbBoxK * (kFbRows + p.bn);
  double t = flops / kFbSmFlopsUs;
  if (hbm / kFbSmHbmBytesUs > t) t = hbm / kFbSmHbmBytesUs;
  if (l2 / kFbSmL2BytesUs > t) t = l2 / kFbSmL2BytesUs;
  return p.items_per_block * (t + kFbItemUs);
}

// The plan of a call, or false where no panel leaves two stages in
// shared memory. The panel: of 256, 128 and 64 columns, those that divide
// N and fit (each with the deepest ring of at most 4 stages that fits),
// the one the cost model rates fastest, the wider on a tie. The block
// walk: block b takes panel b % panels and row tiles b / panels, +
// blocks_per_panel, ... The statistics: a thread sums its column pair
// over its warp's 16 rows of each of its items in turn; the block sums
// its 8 warps' rows in order; the last block of each merge group sums the
// group's block rows in block order; the last group of the panel to
// finish sums the group rows in order. So a column's sum passes through
// at most items_per_block * 16 + 8 + group + groups terms (stat_depth).
inline bool fb_plan(FbPlan& p, int M, int K, int N, int bn_relu, int sm_count, int per_sm) {
  p = FbPlan{};
  if (M < 1 || K < 1 || N < 64 || N % 64 || sm_count < 1 || per_sm < 1) return false;
  const int kblocks = fb_cdiv(K, kFbBoxK);
  const int widths[3] = {256, 128, 64};
  double best = -1.0;
  for (int i = 0; i < 3; ++i) {
    FbPlan c{};
    c.bn = widths[i];
    c.box_k = kFbBoxK;
    c.kblocks = kblocks;
    if (N % c.bn || (FB_PANEL && c.bn > FB_PANEL)) continue;
    c.stages = FB_STAGES ? FB_STAGES : kFbMaxStages;
    while (c.stages > 2 && fb_smem(c.bn, c.stages, kblocks, bn_relu) > kFbMaxSmem) --c.stages;
    if (fb_smem(c.bn, c.stages, kblocks, bn_relu) > kFbMaxSmem) continue;
    const double cost = fb_grid(c, M, K, N, sm_count, per_sm);
    if (best < 0.0 || cost < best) best = cost, p = c;
  }
  if (best < 0.0) return false;
  int group = 1;
  while (group * group < p.blocks_per_panel) ++group;
  p.group = FB_ONE_LEVEL_MERGE ? p.blocks_per_panel : group;
  p.groups = fb_cdiv(p.blocks_per_panel, p.group);
  p.transforms = bn_relu ? p.panels : 0;
  p.stat_depth = p.items_per_block * kFbStatRows + kFbStatParts + p.group + p.groups;
  p.smem = fb_smem(p.bn, p.stages, kblocks, bn_relu);
  p.part_floats = (p.grid + p.panels * p.groups) * 2 * p.bn;
  p.counters = p.panels * (p.groups + 1);
  p.per_sm = per_sm;
  return true;
}

// Block b's panel, its first row tile, and the row tile of its walk's
// step `it` (-1 past its last).
FB_HD inline int fb_panel(const FbPlan& p, int b) { return b % p.panels; }
FB_HD inline int fb_tile(const FbPlan& p, int b, int it) {
  const int t = b / p.panels + it * p.blocks_per_panel;
  return t < p.row_tiles ? t : -1;
}

constexpr int kFbPlanInts = 18;

// The plan as ints, FbPlan's fields in order (ops/fused_block's fields).
inline void fb_plan_ints(const FbPlan& p, int* out) {
  const int f[kFbPlanInts] = {p.bn,      p.panels,          p.box_k,           p.kblocks,
                              p.stages,  p.row_tiles,       p.items,           p.grid,
                              p.blocks_per_panel, p.items_per_block, p.group,  p.groups,
                              p.transforms, p.stat_depth,   p.smem,            p.part_floats,
                              p.counters, p.per_sm};
  for (int i = 0; i < kFbPlanInts; ++i) out[i] = f[i];
}

}  // namespace
