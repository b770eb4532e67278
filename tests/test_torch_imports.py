"""The port stands alone: no file of ``distributeddeeplearning_tpu_torch``
and not ``chip_smoke.py`` or ``scripts/elastic_dp_check.py`` imports
``jax`` or the JAX package (the serving control plane's modules,
``obs.rollup``, ``obs.slo``, ``obs.traces``, ``serving.loadgen`` and
``serve_bench``, among them), importing the whole port leaves ``jax``
unloaded, the process tier (``launch``, ``faults``, ``obs.tail``,
``obs.report``) and the live plane (``obs.rollup``, ``obs.slo``,
``obs.traces``) import neither torch nor JAX, the real-data plane
(``native``, ``data.imagenet``, ``data.prepare``, ``data.stream``,
``streamgen``, ``stream_bench``, ``real_data_bench``) imports neither
JAX nor TensorFlow nor PIL when imported, the model and optimizer knobs
(``models.moe``, AdamW, the ``moe_audit`` twin) import no JAX, nor do
the serving fleet (``serving.chaos``, ``serving.fleet.*``) and its bench
twins, nor the mesh engines (``parallel.mesh``, ``parallel.ring_attention``,
``models.sharding``, ``models.pipeline_lm``, the pjit, sp and pp steps,
``training.overlap``, ``pp_schedule_bench``, ``scripts/mesh_check.py``),
nor ``scripts/fleet_fairness_trace.py``, nor the expert-parallel path
(``config``, ``models.moe``, the pjit step, the checkpoint, ``fit``, the
LM example, ``scripts/mesh_check.py`` and ``chip_smoke.py`` loaded whole),
nor the kernel wrappers' routes (``ops.flash``, ``ops.flash_packed``,
``ops.fused_block``, ``ops.paged_decode``: the generic and f32 kernels
and decode at head dim 96), and the entry points (the fleet's replicas
and benches among them) default to the CUDA device instead of falling
back to the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "distributeddeeplearning_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "distributeddeeplearning_tpu")


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "scripts" / "elastic_dp_check.py",
                                         ROOT / "scripts" / "fleet_fairness_trace.py",
                                         ROOT / "scripts" / "mesh_check.py",
                                         ROOT / "scripts" / "spec_draft_profile.py",
                                         ROOT / "scripts" / "spec_harness_ab.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name):
    top = name.split(".")[0]
    return top in FORBIDDEN


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [name for name in _imported(tree) if _forbidden(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_leaves_jax_unloaded():
    mods = sorted(
        "distributeddeeplearning_tpu_torch."
        + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py"
    )
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'distributeddeeplearning_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("module", ["launch", "faults", "obs.tail", "obs.report",
                                    "obs.rollup", "obs.slo", "obs.traces"])
def test_process_tier_imports_neither_torch_nor_jax(module):
    """The launcher and its supervisor read exit codes, capacity files
    and event files without loading torch (a card world's launcher
    imports it only to check for CUDA) or JAX; so do the live plane's
    rollups, SLO engine and trace reconstruction."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module('distributeddeeplearning_tpu_torch.{module}')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'distributeddeeplearning_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


DATA_PLANE = ["native", "native.example_proto", "data", "data.imagenet", "data.prepare",
              "data.stream", "data.stream.index", "data.stream.shuffle", "data.stream.reader",
              "data.stream.records", "data.stream.tokens", "data.stream.prefetch",
              "streamgen", "stream_bench", "real_data_bench"]


@pytest.mark.parametrize("module", DATA_PLANE)
def test_data_plane_imports_neither_jax_nor_tensorflow_nor_pil(module):
    """The real-data plane imports no JAX and nothing of the JAX package
    (its copies of the jax-free modules included), and TensorFlow and
    PIL only when a reader decodes: the card has neither, and the
    smoke's ``realdata`` phase checks for them before it decodes."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module('distributeddeeplearning_tpu_torch.{module}')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'distributeddeeplearning_tpu', 'tensorflow', 'PIL')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


MESH_ENGINES = ["parallel.mesh", "parallel.collectives", "parallel.ring_attention",
                "models.sharding", "models.pipeline_lm", "training.overlap",
                "training.pjit_step", "training.sp_step", "training.pp_step",
                "training.engines", "pp_schedule_bench"]


@pytest.mark.parametrize("module", ["models.moe", "models.transformer_lm", "models.vit",
                                    "models.resnet", "training.optimizer", "moe_audit"]
                         + MESH_ENGINES)
def test_model_and_optimizer_knobs_import_no_jax(module):
    """The MoE blocks, REMAT and dropout, the ResNet knobs, AdamW and the
    MoE audit import no JAX and nothing of the JAX package."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module('distributeddeeplearning_tpu_torch.{module}')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'distributeddeeplearning_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


EP_PATH = ["config", "models.moe", "models.sharding", "parallel.collectives", "parallel.mesh",
           "training.pjit_step", "training.checkpoint", "training.engines", "training.loop",
           "examples.lm_synthetic", "scripts/mesh_check.py", "chip_smoke.py"]


@pytest.mark.parametrize("module", EP_PATH)
def test_expert_parallel_path_imports_no_jax(module):
    """The expert-parallel path (the MoE block's EP forward, its layout,
    collectives, checkpoint and entry points) and the scripts that drive
    it on the card load no JAX and nothing of the JAX package."""
    if module.endswith(".py"):
        load = (f"spec = importlib.util.spec_from_file_location('m', {str(ROOT / module)!r})\n"
                "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n")
    else:
        load = f"importlib.import_module('distributeddeeplearning_tpu_torch.{module}')\n"
    code = (
        "import importlib, importlib.util, sys\n" + load +
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'distributeddeeplearning_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


KERNEL_WRAPPERS = ["ops.flash", "ops.flash_packed", "ops.fused_block", "ops.paged_decode",
                   "ops._build", "models.vit", "models.resnet", "chip_smoke.py"]


@pytest.mark.parametrize("module", KERNEL_WRAPPERS)
def test_kernel_route_wrappers_import_no_jax(module):
    """The wrappers that route the inputs JAX's kernels take to the
    generic CUDA kernels (flash and packed attention, the f32 fused
    block, decode at head dim 96), the models that call them, and the
    smoke that drives them load no JAX and nothing of the JAX package."""
    test_expert_parallel_path_imports_no_jax(module)


FLEET_MODULES = ("serving.chaos", "serving.blocks", "serving.fleet", "serving.fleet.replica",
                 "serving.fleet.router", "serving.fleet.controller", "fleet_bench",
                 "disagg_bench", "chaos_bench")


def test_serving_fleet_imports_no_jax():
    """The chaos plane, the prefix directory, the fleet and its bench
    twins (copies of jax-free JAX modules among them) import no JAX and
    nothing of the JAX package."""
    code = (
        "import importlib, sys\n"
        f"for m in {FLEET_MODULES!r}: "
        "importlib.import_module('distributeddeeplearning_tpu_torch.' + m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'distributeddeeplearning_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_fleet_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from distributeddeeplearning_tpu_torch.models.transformer_lm import TransformerLM
    from distributeddeeplearning_tpu_torch.serving import (
        FleetConfig,
        Replica,
        ServeConfig,
        build_fleet,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = TransformerLM("tiny", vocab_size=64, max_seq_len=32, device="meta")
    scfg = ServeConfig(num_slots=2, buckets=(8,))
    with pytest.raises(RuntimeError, match="CUDA"):
        Replica(0, model, None, scfg, max_len=32).start(threaded=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_fleet(model, None, fleet_config=FleetConfig(replicas=1), serve_config=scfg,
                    max_len=32, threaded=False)


def test_fleet_benches_default_to_cuda_and_fail_without_it():
    """Without ``BENCH_DEVICE`` each bench twin asks for the card: with
    no CUDA it prints its error record and exits non-zero (the three run
    at once)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    env.pop("BENCH_DEVICE", None)
    procs = [subprocess.Popen([sys.executable, "-m", f"distributeddeeplearning_tpu_torch.{m}"],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for m in ("fleet_bench", "disagg_bench", "chaos_bench")]
    for proc in procs:
        out, _ = proc.communicate(timeout=120)
        assert proc.returncode != 0
        assert '"error"' in out and "CUDA" in out


def test_engine_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from distributeddeeplearning_tpu_torch.models.transformer_lm import TransformerLM
    from distributeddeeplearning_tpu_torch.serving import Server, SlotEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = TransformerLM("tiny", vocab_size=64, max_seq_len=32, device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        SlotEngine(model, num_slots=2, device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        Server.build(model)


def test_model_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.models.transformer_lm import TransformerLM

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        get_model("lm_tiny", num_classes=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        TransformerLM("tiny", vocab_size=64, max_seq_len=32)
    assert get_model("lm_tiny", num_classes=64, device="meta").tok_embed.is_meta


def test_kernel_wrapper_raises_on_unsupported_device():
    from distributeddeeplearning_tpu_torch.ops import paged_decode

    q = torch.zeros(1, 1, 2, 32, device="meta")
    k = torch.zeros(1, 4, 2, 32, device="meta")
    pos = torch.zeros(1, 1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        paged_decode.fused_decode_attention(q, k, k, pos)


def test_loop_engine_and_bench_default_to_cuda_and_raise_without_it(monkeypatch):
    from distributeddeeplearning_tpu_torch import bench
    from distributeddeeplearning_tpu_torch.config import TrainConfig
    from distributeddeeplearning_tpu_torch.data import make_dataset
    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.training import create_optimizer, loop
    from distributeddeeplearning_tpu_torch.training.engines import build_engine

    cfg = TrainConfig(model="resnet18", num_classes=8, image_size=16, batch_size_per_device=2,
                      fake_data_length=4)
    model = get_model("resnet18", num_classes=8, device="meta")
    tx, _ = create_optimizer(cfg, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("BENCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        loop.fit(model, cfg, make_dataset(cfg))
    with pytest.raises(RuntimeError, match="CUDA"):
        loop.evaluate(model, cfg, make_dataset(cfg, train=False), state=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_engine(model, cfg, tx)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench._device()
