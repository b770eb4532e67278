"""Sync BatchNorm (``ALLOW_SYNC_BN=1``) under the port's pjit engine
against the JAX package's: ResNet-18 at 64 px in f32, 8 images, one
step on ``(data 2)`` from JAX's init, the statistics of the whole batch
(the set-up, limits and one-step reason of ``test_torch_pjit_bn.py``).
The two BN modes are different semantics: the port's sync and
per-replica steps differ by far more than the limit (asserted).
"""

import pytest

from test_torch_pjit_bn import assert_matches_jax, jax_runs_of, port_runs_of


@pytest.fixture(scope="module")
def jax_runs():
    return jax_runs_of(["sync_data2"])


@pytest.fixture(scope="module")
def port(jax_runs, tmp_path_factory):
    return port_runs_of(["sync_data2", "per_replica_data2"], jax_runs,
                        tmp_path_factory.mktemp("pjit_sync_bn"))


def test_sync_bn_under_pjit_matches_jax(jax_runs, port):
    assert_matches_jax(jax_runs["sync_data2"], port["sync_data2"])


def test_sync_and_per_replica_bn_differ(port):
    sync, per_replica = port["sync_data2"]["state"], port["per_replica_data2"]["state"]
    gap = max(float((sync["model"][k] - per_replica["model"][k]).abs().max())
              for k in sync["model"])
    assert gap > 1e-3  # the BN modes are different semantics
