// depthwise_plan.h built alone for the host (ops/_build compiles it with
// the host's C++ compiler): the TMA wgrad's plan where no card answers the
// occupancy question, the strips planned for `per_sm` blocks an SM on
// `sm_count` SMs. depthwise.cu exports the same function for the card,
// where sm_count and per_sm come from the device.

#include "depthwise_plan.h"

// out: kWgPlanInts ints (wgrad_plan_ints). path: 0 = TMA, 1 = staged
// tile, 2 = direct, as ops/depthwise.stencil_path picks. dtype: 0 = bf16,
// 1 = f32. Returns 0, or 1 where the arguments or the plan do not hold.
extern "C" int depthwise_wgrad_plan_host(int B, int H, int W, int C, int K, int dtype, int path,
                                         int sm_count, int per_sm, int* out) {
  const Shape s = {B, H, W, C};
  if (B < 1 || H < K || W < K || C < 1 || K < 3 || K % 2 == 0 || dtype < 0 || dtype > 1 ||
      path < 0 || path > 2 || sm_count < 1 || per_sm < 1)
    return 1;
  if (path != 0) {
    wgrad_plan_ints(nullptr, s, path, out);
    return 0;
  }
  WgPlan p;
  if (K > 7 || !wg_geometry(p, s, K, dtype == 0 ? 2 : 4)) return 1;
  plan_strips(p, s, K, sm_count, per_sm);
  wgrad_plan_ints(&p, s, path, out);
  return 0;
}
