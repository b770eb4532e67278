// fused_block_plan.h built alone for the host (ops/_build compiles it with
// the host's C++ compiler): the fused-bottleneck kernel's plan where no
// card answers the occupancy question, for `per_sm` blocks an SM on
// `sm_count` SMs. fused_block.cu exports the same plan for the card,
// where sm_count and per_sm come from the device.

#include "fused_block_plan.h"

// out: kFbPlanInts ints (fb_plan_ints). Returns 0, or 1 where the
// arguments or the plan do not hold.
extern "C" int fused_block_plan_host(int M, int K, int N, int bn_relu, int sm_count, int per_sm,
                                     int* out) {
  FbPlan p;
  if (!fb_plan(p, M, K, N, bn_relu != 0, sm_count, per_sm)) return 1;
  fb_plan_ints(p, out);
  return 0;
}

// The blocks' walk: out[(b * items_per_block + it) * 2 + {0, 1}] = (row
// tile, panel) of block b's step it, (-1, -1) past its last. out holds
// grid x items_per_block x 2 ints. Returns 0, or 1 where no plan holds.
extern "C" int fused_block_walk_host(int M, int K, int N, int bn_relu, int sm_count, int per_sm,
                                     int* out) {
  FbPlan p;
  if (!fb_plan(p, M, K, N, bn_relu != 0, sm_count, per_sm)) return 1;
  for (int b = 0; b < p.grid; ++b)
    for (int it = 0; it < p.items_per_block; ++it) {
      const int t = fb_tile(p, b, it);
      out[(b * p.items_per_block + it) * 2] = t;
      out[(b * p.items_per_block + it) * 2 + 1] = t < 0 ? -1 : fb_panel(p, b);
    }
  return 0;
}
