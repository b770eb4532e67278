"""Checkpoint / resume: the port of the JAX package's
``training/checkpoint.py`` (``:86-469``) without orbax, on the same
contract.

* **Layout.** One directory per step key under ``MODEL_DIR``:
  ``<dir>/<key>/state.pt`` (``torch.save`` of the model's
  ``state_dict`` with the BatchNorm buffers, the optimizer state, the
  ``MultiSteps`` running mean included, and the step count) and
  ``<dir>/<key>/manifest.json``, JAX's JSON manifest field for field
  (:func:`build_manifest`, ``MANIFEST_FORMAT = 1``). A save is written
  into a temporary directory and renamed into place, so a key directory
  is either whole or absent; a truncated one (a preemption mid-write,
  rehearsed by ``faults.corrupt_latest_checkpoint``) fails to load and
  the restore falls back to the next older key with a
  ``checkpoint_corrupt`` point.
* **Keying.** Epoch keys by default (``save_every_epochs``); with
  ``save_every_steps > 0`` (``CHECKPOINT_EVERY_STEPS``) the key is the
  count of completed optimizer steps, mid-epoch saves in between, and
  :meth:`CheckpointManager.maybe_restore_at` hands back ``(epoch,
  step_in_epoch)`` from the manifest so the loop skips exactly the
  batches already trained.
* **Ranks.** Every rank holds the same state (data parallel), so rank 0
  writes and the others wait at a barrier (``torch.distributed``); every
  rank reads on restore. A mesh engine's state (``state.layout``: the
  pjit engine's slices, the pp engine's stages) is gathered into whole
  arrays first, every rank taking part: the checkpoint holds the dp
  model's state dict (stages stacked ``[S, …]``, as JAX's manifest
  does), and a restore slices each rank's part back out, so the same
  checkpoint resumes under another layout of the same model.
* **Async.** The copy to the host happens at once, inside ``save*``,
  booked as one host sync labelled ``checkpoint``
  (``utils/hostsync.device_get``): the optimizer updates the parameters
  in place, so the copy must be taken before the next step. With
  ``async_save`` the write then runs on a thread; :meth:`wait` makes it
  durable (and re-raises its error). Without it every save is durable
  when ``save*`` returns.
* ``max_to_keep`` newest keys are kept (default 3).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import torch

from distributeddeeplearning_tpu_torch import faults, obs
from distributeddeeplearning_tpu_torch.parallel import collectives
from distributeddeeplearning_tpu_torch.training.state import TrainState
from distributeddeeplearning_tpu_torch.utils import hostsync
from distributeddeeplearning_tpu_torch.utils.logging import get_logger

#: Manifest schema version (JAX's).
MANIFEST_FORMAT = 1
STATE_FILE = "state.pt"
MANIFEST_FILE = "manifest.json"


def build_manifest(
    *,
    global_step: int,
    steps_per_epoch: int,
    effective_batch: int,
    accum_steps: int = 1,
    world_size: Optional[int] = None,
    process_count: Optional[int] = None,
    data_cursor: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Where the run is (``epoch``/``step_in_epoch``) and what geometry
    produced it (``effective_batch``, ``accum_steps``, ``world_size``):
    JAX's ``build_manifest``, field for field. ``world_size`` and
    ``process_count`` default to the ``torch.distributed`` world (one
    process per GPU, so both are its size)."""
    spe = max(int(steps_per_epoch), 1)
    world = collectives.size()
    out = {
        "format": MANIFEST_FORMAT,
        "global_step": int(global_step),
        "epoch": int(global_step) // spe,
        "step_in_epoch": int(global_step) % spe,
        "steps_per_epoch": spe,
        "effective_batch": int(effective_batch),
        "accum_steps": int(accum_steps),
        "world_size": int(world_size) if world_size is not None else world,
        "process_count": int(process_count) if process_count is not None else world,
    }
    if data_cursor:
        out["data_cursor"] = dict(data_cursor)
    return out


def _payload(state) -> Any:
    """What a save holds: a TrainState as ``{step, model, opt}`` (a
    mesh engine's gathered whole: collective, every rank calls it); any
    other tree (dicts and lists of tensors and numbers) as it is."""
    if isinstance(state, TrainState):
        layout = state.layout
        if layout is not None:
            return {"step": int(state.step), "model": layout.state_dict(),
                    "opt": layout.per_param(layout.full, state.opt_state)}
        return {"step": int(state.step), "model": state.model.state_dict(),
                "opt": state.opt_state}
    return state


def _load_into(live, saved, where: str = "state"):
    """Copy ``saved`` into ``live`` in place, tensor by tensor (so the
    optimizer and the model keep their tensors); returns the updated
    tree. Structure, shapes and dtypes must agree."""
    if torch.is_tensor(live):
        if not torch.is_tensor(saved) or saved.shape != live.shape or saved.dtype != live.dtype:
            raise ValueError(f"{where}: checkpoint holds {saved!r:.80}, the live state "
                             f"{tuple(live.shape)} {live.dtype}")
        with torch.no_grad():
            live.copy_(saved)
        return live
    if isinstance(live, dict):
        if not isinstance(saved, dict) or set(saved) != set(live):
            raise ValueError(f"{where}: checkpoint keys differ from the live state's")
        for k in live:
            live[k] = _load_into(live[k], saved[k], f"{where}.{k}")
        return live
    if isinstance(live, list):
        if not isinstance(saved, list) or len(saved) != len(live):
            raise ValueError(f"{where}: checkpoint list length differs from the live state's")
        for i in range(len(live)):
            live[i] = _load_into(live[i], saved[i], f"{where}[{i}]")
        return live
    return saved


class CheckpointManager:
    """The JAX ``CheckpointManager``'s semantics on the port's layout
    (module docstring). ``directory=None`` disables it."""

    def __init__(self, directory: Optional[str], *, max_to_keep: int = 3,
                 save_every_epochs: int = 1, save_every_steps: int = 0,
                 async_save: bool = True):
        self._log = get_logger()
        self._save_every = max(save_every_epochs, 1)
        self._every_steps = max(int(save_every_steps), 0)
        self._keep = max(int(max_to_keep), 1)
        self._steps_per_epoch: Optional[int] = None
        self._async = bool(async_save)
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pending: Optional[Future] = None
        #: Manifest of the most recent successful restore (the loop reads
        #: it for the effective-batch check).
        self.last_manifest: Optional[Dict[str, Any]] = None
        self.directory = (os.path.abspath(os.path.expanduser(directory))
                          if directory is not None else None)
        self._latest: Optional[int] = None
        if self.directory is not None:
            if collectives.is_master():
                os.makedirs(self.directory, exist_ok=True)
            steps = faults.checkpoint_steps(self.directory)
            self._latest = steps[-1] if steps else None

    @property
    def enabled(self) -> bool:
        return self.directory is not None

    @property
    def step_granular(self) -> bool:
        """True when keys are global optimizer steps
        (``CHECKPOINT_EVERY_STEPS > 0``) rather than epochs."""
        return self._every_steps > 0

    def all_steps(self):
        return faults.checkpoint_steps(self.directory) if self.enabled else []

    # -- saving -----------------------------------------------------------

    def _write(self, key: int, host_state, manifest: Dict[str, Any]) -> None:
        """Write one key into a temporary directory, rename it into
        place, then drop keys past ``max_to_keep`` (rank 0 only)."""
        tmp = tempfile.mkdtemp(prefix=f".tmp-{key}-", dir=self.directory)
        try:
            torch.save(host_state, os.path.join(tmp, STATE_FILE))
            with open(os.path.join(tmp, MANIFEST_FILE), "w") as fh:
                json.dump(manifest, fh)
            final = os.path.join(self.directory, str(key))
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        finally:
            if os.path.isdir(tmp):
                shutil.rmtree(tmp, ignore_errors=True)
        for old in faults.checkpoint_steps(self.directory)[:-self._keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)

    def _save(self, key: int, state, manifest, label: Dict[str, int]) -> bool:
        if callable(manifest):
            manifest = manifest()
        manifest = dict(manifest or {})
        with obs.span("checkpoint_save", **label):
            payload = _payload(state)
            if collectives.is_master():
                self._drain()  # one write in flight at a time
                host_state = hostsync.device_get(payload, label="checkpoint")
                if self._async:
                    if self._pool is None:
                        self._pool = ThreadPoolExecutor(1, thread_name_prefix="ddl-ckpt")
                    self._pending = self._pool.submit(self._write, key, host_state, manifest)
                else:
                    self._write(key, host_state, manifest)
            collectives.barrier()
        self._latest = key
        self._log.info("checkpoint saved", extra=label)
        return True

    def save(self, epoch: int, state, force: bool = False, manifest=None) -> bool:
        """Save at the end of ``epoch`` (0-based) if due (epoch keys);
        returns True if saved."""
        if not self.enabled:
            return False
        if not force and (epoch + 1) % self._save_every != 0:
            return False
        return self._save(epoch, state, manifest, {"epoch": epoch})

    def save_step(self, global_step: int, state, force: bool = False, manifest=None) -> bool:
        """Step-granular save: key = completed optimizer steps, due every
        ``save_every_steps`` (``force`` saves regardless). Idempotent per
        key."""
        if not self.enabled or not self.step_granular:
            return False
        if not force and (global_step <= 0 or global_step % self._every_steps != 0):
            return False
        if self._latest == global_step:
            return False  # already saved (epoch boundary == due step)
        return self._save(global_step, state, manifest, {"step": global_step})

    def save_epoch_end(self, epoch: int, state, global_step: Optional[int] = None,
                       manifest=None) -> bool:
        """The epoch-boundary call under either keying: epoch keys defer
        to :meth:`save`; step keys save the boundary's global step when
        the epoch policy says the epoch is due."""
        if self.step_granular and global_step is not None:
            if (epoch + 1) % self._save_every != 0:
                return False
            return self.save_step(global_step, state, force=True, manifest=manifest)
        return self.save(epoch, state, manifest=manifest)

    # -- restoring --------------------------------------------------------

    def latest_epoch(self) -> Optional[int]:
        """The newest key on disk (every rank reads the same answer)."""
        if not self.enabled:
            return None
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state, epoch: Optional[int] = None):
        """Restore key ``epoch`` (default: the newest) into ``state`` in
        place and return it; :attr:`last_manifest` is the key's
        manifest. A TrainState gets its model (parameters and buffers),
        optimizer state and step; another tree its tensors.

        A restore into another world than the manifest's (an elastic
        relaunch) emits an ``elastic.world_resized`` point and the
        ``elastic.reshard_ms`` gauge, as JAX's does: the data-parallel
        state is whole on every rank, so the reshard is the reload, and
        its cost is reported all the same."""
        if not self.enabled:
            raise RuntimeError("checkpointing disabled (no directory)")
        self._drain()
        key = epoch if epoch is not None else self.latest_epoch()
        if key is None:
            raise FileNotFoundError("no checkpoint to restore")
        path = os.path.join(self.directory, str(key))
        self.last_manifest = None
        t0 = time.monotonic()
        with obs.span("checkpoint_restore", epoch=key):
            saved = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                               weights_only=True)
            with open(os.path.join(path, MANIFEST_FILE)) as fh:
                manifest = json.load(fh)
            if isinstance(state, TrainState) and state.layout is not None:
                layout = state.layout
                layout.load_state_dict(saved["model"])
                _load_into(state.opt_state, layout.per_param(
                    lambda n, t: layout.slice(n, t), saved["opt"]), "opt")
                state.step = int(saved["step"])
                restored = state
            elif isinstance(state, TrainState):
                state.model.load_state_dict(saved["model"])
                _load_into(state.opt_state, saved["opt"], "opt")
                state.step = int(saved["step"])
                restored = state
            else:
                restored = _load_into(state, saved)
        self.last_manifest = manifest or None
        saved_world = (manifest or {}).get("world_size")
        world = collectives.size()
        if saved_world is not None and saved_world != world:
            obs.point("elastic.world_resized", step=key, from_world=saved_world, to_world=world)
            obs.gauge("elastic.reshard_ms", (time.monotonic() - t0) * 1000.0)
        self._log.info("checkpoint restored", extra={"epoch": key})
        return restored

    def _restore_latest_valid(self, state) -> Tuple[Any, Optional[int]]:
        """Newest-first restore with fallback past keys that fail to
        load; ``(state, None)`` when nothing restores."""
        for key in sorted(self.all_steps(), reverse=True):
            try:
                return self.restore(state, key), key
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:  # a truncated or foreign key: try the next older
                self._log.warning("checkpoint %d unreadable (%r); falling back to the "
                                  "previous one", key, e)
                obs.point("checkpoint_corrupt", step=key, error=repr(e))
        return state, None

    def maybe_restore(self, state) -> Tuple[Any, int]:
        """``(state, start_epoch)``; ``(state, 0)`` when there is nothing
        to resume (or every checkpoint is corrupt)."""
        restored, epoch, skip = self.maybe_restore_at(state)
        if skip:
            raise ValueError(
                "mid-epoch checkpoint found but caller uses the epoch-only "
                "resume contract — resume through maybe_restore_at()")
        return restored, epoch

    def maybe_restore_at(self, state, steps_per_epoch: Optional[int] = None
                         ) -> Tuple[Any, int, int]:
        """``(state, start_epoch, skip_steps)``: resume at
        ``start_epoch``, skipping its first ``skip_steps`` batches.
        Epoch keys always give ``skip_steps == 0``."""
        if steps_per_epoch:
            self._steps_per_epoch = int(steps_per_epoch)
        if not self.enabled:
            return state, 0, 0
        restored, key = self._restore_latest_valid(state)
        if key is None:
            return state, 0, 0
        m = self.last_manifest
        if m and "epoch" in m and "step_in_epoch" in m:
            return restored, int(m["epoch"]), int(m["step_in_epoch"])
        if not self.step_granular:
            return restored, key + 1, 0
        spe = self._steps_per_epoch
        if not spe:
            raise ValueError("step-granular restore needs steps_per_epoch to decode the "
                             "checkpoint key (pass it to maybe_restore_at)")
        return restored, key // spe, key % spe

    # -- lifetime ---------------------------------------------------------

    def _drain(self) -> None:
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()  # re-raises a failed write

    def wait(self) -> None:
        """Block until the pending save is durable on every rank."""
        if self.enabled:
            self._drain()
            collectives.barrier()

    def close(self) -> None:
        self.wait()
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None
