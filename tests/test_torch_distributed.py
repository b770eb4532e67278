"""The port's rendezvous (``parallel/distributed.py``) against the JAX
package's contract: without ``DDL_*`` (and without ``DISTRIBUTED`` and
torch's ``env://`` variables) ``maybe_initialize`` is a no-op returning
False, as JAX's is; ``DDL_COORDINATOR`` without the process count or id
raises; a one-rank gloo world forms, a second call is a no-op returning
True, and ``shutdown`` tears it down; ``default_device`` is the CPU only
under ``DDL_PLATFORM=cpu`` and raises without CUDA otherwise; and a
2-process gloo world formed from ``DDL_*`` alone trains the Keras-style
example (``examples.imagenet_keras``, ResNet-50 at 32 px, 2 images a
rank, 4 steps), the twin of
``test_launch.py::test_two_process_keras_frontend_end_to_end`` without
the launcher."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from distributeddeeplearning_tpu_torch.parallel import distributed

ROOT = Path(__file__).resolve().parent.parent
DDL = ("DDL_COORDINATOR", "DDL_NUM_PROCESSES", "DDL_PROCESS_ID", "DDL_PLATFORM",
       "DISTRIBUTED", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "TPU_WORKER_HOSTNAMES")


@pytest.fixture
def clean_env(monkeypatch):
    for k in DDL:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("env", [{}, {"DISTRIBUTED": "True"}], ids=["none", "distributed-only"])
def test_no_rendezvous_without_settings_like_jax(clean_env, env):
    from distributeddeeplearning_tpu.parallel import distributed as jax_distributed

    for k, v in env.items():
        clean_env.setenv(k, v)
    assert distributed.maybe_initialize() is False
    assert jax_distributed.maybe_initialize() is False
    assert not dist.is_initialized()


def test_coordinator_needs_count_and_id(clean_env):
    clean_env.setenv("DDL_COORDINATOR", "127.0.0.1:1")
    with pytest.raises(ValueError, match="DDL_NUM_PROCESSES"):
        distributed.maybe_initialize()


def test_one_rank_gloo_world_is_idempotent(clean_env):
    clean_env.setenv("DDL_PLATFORM", "cpu")
    try:
        assert distributed.maybe_initialize(f"127.0.0.1:{_free_port()}", 1, 0) is True
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert dist.get_backend() == "gloo"
        assert distributed.maybe_initialize() is True  # hvd.init() semantics
    finally:
        distributed.shutdown()
    assert not dist.is_initialized()


def test_default_device(clean_env):
    clean_env.setenv("DDL_PLATFORM", "cpu")
    assert distributed.default_device() == torch.device("cpu")
    clean_env.delenv("DDL_PLATFORM")
    clean_env.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed.default_device()


def test_two_process_keras_example_from_ddl_env_alone():
    port = _free_port()
    base = {k: v for k, v in os.environ.items() if k not in DDL}
    base.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2", DDL_PLATFORM="cpu",
                DDL_COORDINATOR=f"127.0.0.1:{port}", DDL_NUM_PROCESSES="2", FAKE="True",
                FAKE_DATA_LENGTH="16", EPOCHS="1", BATCHSIZE="2", IMAGE_SIZE="32",
                NUM_CLASSES="8", MODEL="resnet18")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "distributeddeeplearning_tpu_torch.examples.imagenet_keras"],
        cwd=ROOT, env=dict(base, DDL_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (r, out[-4000:])
        assert "distributed initialized: process %d/2, backend gloo" % r in out, out[-4000:]
        assert "images/sec" in out, out[-4000:]
    # 16 images over a global batch of 4: 4 steps on each rank
    assert "Total images processed: 16" in outs[0], outs[0][-4000:]
