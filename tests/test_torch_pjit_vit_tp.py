"""The dW+db route under the port's pjit ``tp`` on ``(data 1, model 2)``
against the JAX package's GSPMD step: the head keeps its dW+db route,
the blocks' Dense layers are the Megatron halves (the set-up and limits
of ``test_torch_pjit_vit.py``)."""

import pytest

from test_torch_pjit_vit import assert_matches_jax, jax_runs_of, port_runs_of


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    want = jax_runs_of(["tp"])
    return want, port_runs_of(want, tmp_path_factory.mktemp("pjit_vit_tp"))


def test_fused_grad_dense_under_pjit_tp_matches_jax(runs):
    want, got = runs
    assert_matches_jax("tp", want["tp"], got["tp"])
