"""One process: the port's fused ResNet-50 train step (the fused-block
ops' plain versions and custom backward on the CPU) against the JAX
package's fused dp step (its Pallas kernels interpreted) on a 1-device
CPU mesh, from the same weights over two batches. Tolerances:
``_torch_train_common.assert_step_matches``."""

from _torch_train_common import CFG, assert_step_matches, batches, run_jax
from test_torch_train_step import run_port


def test_fused_train_step_matches_jax_dp_step():
    data = batches(2, global_batch=CFG["batch_size_per_device"])
    init, want_metrics, want_final = run_jax(True, 1, data)
    got_metrics, got_final = run_port(True, init, data)
    assert_step_matches(init, want_metrics, want_final, got_metrics, got_final)
