"""Checkpoint save/restore and two-stage resume (the port of
tpu_reid/runtime/checkpoint.py), on torch.save / torch.load.

A payload is a nested dict / list / tuple of tensors, ints, floats, strings
and None: the parameters with their stage markers, or the companion
"extras" (the optimizer's state dict, the GPA sum, the XBM banks). Files:

    <directory>/<epoch>.pt          {"params", "stage", "epoch_in_stage"}
    <directory>/extras_<epoch>.pt   {"optimizer", "opt_paths", "gpa", "xbms"}

What orbax gave the JAX package for free is done here by hand:

  * every write goes to a temporary file in the same directory and is
    renamed into place (`os.replace`), so `latest_epoch` only ever sees
    finished files;
  * `save` copies every tensor to host memory before it returns (the
    trainers update their leaves in place), and only the file write runs on
    a background thread, one write at a time; `close()` waits for it;
  * the optimizer's state dict keys its moments by position, so the ordered
    leaf paths it was built over are saved beside it (`opt_paths`) and
    `restore_extras` raises when they differ from the restoring run's;
  * `extras_<epoch>` is pruned with its epoch (the JAX package keeps them).

Over a "data" mesh (parallel/mesh.py) rank 0 alone writes: a manager made
with `mesh=` on another rank decides the cadence and writes nothing. Every
rank restores the same files, and `two_stage_resume` checks that the ranks
then hold identical parameters and optimizer state.

The port cannot read the JAX package's orbax checkpoints, nor the JAX
package the port's.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import re
import tempfile
from typing import Any, Callable, List, Optional

import torch

from tpu_reid_torch.device import DeviceLike
from tpu_reid_torch.parallel.mesh import check_replicated
from tpu_reid_torch.runtime.guard import _to_host

_EPOCH_FILE = re.compile(r"^(\d+)\.pt$")


def save_checkpoint(path: str, payload: Any) -> None:
    """Write `payload` (tensors copied to the host) atomically: a temporary
    file beside `path`, then a rename."""
    _write_file(path, _to_host(payload))


def _write_file(path: str, host_payload: Any) -> None:
    path = os.path.abspath(path)
    directory = os.path.dirname(path)
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".tmp-", suffix=".pt", dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(host_payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str, device: DeviceLike = None) -> Any:
    """Read a payload written by save_checkpoint; tensors land on `device`
    (the CPU when None)."""
    return torch.load(os.path.abspath(path), map_location=device or "cpu", weights_only=True)


class CheckpointManager:
    """Epoch-indexed manager: keeps the newest `max_to_keep` checkpoints
    (and their extras), `latest_epoch()` for resume."""

    def __init__(self, directory: str, max_to_keep: int = 3, save_interval: int = 20,
                 mesh=None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval = save_interval
        self.mesh = mesh
        self.writes = mesh is None or mesh.rank == 0
        os.makedirs(self.directory, exist_ok=True)
        self._writer = cf.ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
        self._pending: List[cf.Future] = []

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"{epoch}.pt")

    def _extras_path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"extras_{epoch}.pt")

    def _wait(self) -> None:
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()  # re-raises a failed write

    def _submit(self, fn, *args) -> None:
        self._pending.append(self._writer.submit(fn, *args))

    def maybe_save(self, epoch: int, payload: Any, last_epoch: bool = False) -> bool:
        """The reference cadence: every `save_interval` epochs and at the end.
        Returns True when a save happened."""
        if (epoch + 1) % self.save_interval == 0 or last_epoch:
            self.save(epoch, payload)
            return True
        return False

    def save(self, epoch: int, payload: Any) -> None:
        """Snapshot `payload` to host memory now; the file is written on the
        writer thread while training goes on. An earlier write is waited for
        first, so at most one is in flight. A rank other than 0 of a mesh
        writes nothing."""
        if not self.writes:
            return
        self._wait()
        self._submit(self._write, epoch, _to_host(payload))

    def _write(self, epoch: int, host_payload: Any) -> None:
        _write_file(self._path(epoch), host_payload)
        self._prune()

    def save_extras(self, epoch: int, payload: Any) -> None:
        """Companion payload of epoch `epoch`'s checkpoint, written after it
        on the writer thread."""
        if not self.writes:
            return
        self._submit(_write_file, self._extras_path(epoch), _to_host(payload))

    def restore_extras(self, epoch: int, opt_paths: Optional[List[str]] = None,
                       device: DeviceLike = None) -> Optional[dict]:
        """The extras of `epoch`, or None when there are none. With
        `opt_paths` (the restoring optimizer's leaf order,
        train/optim.leaf_order), raises ValueError when the saved order
        differs: the moments would land on the wrong leaves."""
        self._wait()
        path = self._extras_path(epoch)
        if not os.path.exists(path):
            return None
        extras = load_checkpoint(path, device)
        saved = list(extras.get("opt_paths", ()))
        if opt_paths is not None and saved != list(opt_paths):
            diff = next(((a, b) for a, b in zip(saved, opt_paths) if a != b), None)
            raise ValueError(
                f"the optimizer state in {path} was saved over other leaves than this run "
                f"trains ({len(saved)} saved, {len(opt_paths)} now; first difference "
                f"{diff})")
        return extras

    def epochs(self) -> List[int]:
        """Epochs with a finished checkpoint file, ascending."""
        out = []
        for name in os.listdir(self.directory):
            m = _EPOCH_FILE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_epoch(self) -> Optional[int]:
        self._wait()
        eps = self.epochs()
        return eps[-1] if eps else None

    def restore(self, epoch: Optional[int] = None, device: DeviceLike = None) -> Any:
        self._wait()
        epoch = epoch if epoch is not None else self.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return load_checkpoint(self._path(epoch), device)

    def _prune(self) -> None:
        eps = self.epochs()
        for e in eps[:max(0, len(eps) - self.max_to_keep)]:
            for path in (self._path(e), self._extras_path(e)):
                if os.path.exists(path):
                    os.unlink(path)

    def close(self) -> None:
        try:
            self._wait()
        finally:
            self._writer.shutdown(wait=True)


class BestKeeper:
    """--keep_best: the parameters of the best mAP among those offered (the
    periodic evaluations and the final test), kept under `directory` as
    {"params", "mAP", "epoch"} (one checkpoint)."""

    def __init__(self, directory: str, log: Callable[..., None], mesh=None):
        self.mgr = CheckpointManager(directory, max_to_keep=1, save_interval=1, mesh=mesh)
        self.log = log
        self.best = -1.0

    def offer(self, epoch: int, params: dict, mAP: float) -> None:
        if mAP > self.best:
            self.best = mAP
            self.mgr.save(epoch, {"params": params, "mAP": float(mAP), "epoch": epoch})
            self.log("best", epoch=epoch, mAP=float(mAP))

    def close(self) -> None:
        self.mgr.close()


# ---------------------------------------------------------------------------
# two-stage training orchestration (shared by the prompt-learning and
# multitask CLIs)
# ---------------------------------------------------------------------------
#
# Stage markers stored with the params: stage 0 = in stage 1, stage 1 +
# epoch_in_stage -1 = stage 1 done, stage 1 + epoch e = in stage 2,
# stage 2 = finished. The extras carry the optimizer state with its leaf
# order and, when used, the GPA sum and the XBM banks.


def two_stage_cb(mgr: CheckpointManager, stage: int, step_of: Callable[[int], int]):
    """checkpoint_cb for run_stage{1,2} / run_mt_stage{1,2}: parameter saves
    at the manager's cadence, each with its extras. step_of maps the
    in-stage epoch to the manager's global step."""

    def _cb(e, p, state):
        if mgr.maybe_save(step_of(e), {"params": p, "stage": stage, "epoch_in_stage": e}):
            extras = {"optimizer": state["optimizer"], "opt_paths": state["opt_paths"]}
            for key in ("gpa", "xbms"):
                if state.get(key) is not None:
                    extras[key] = state[key]
            mgr.save_extras(step_of(e), extras)

    return _cb


def _device_of(tree) -> torch.device:
    if isinstance(tree, dict):
        for v in tree.values():
            dev = _device_of(v)
            if dev is not None:
                return dev
        return None
    return tree.device if isinstance(tree, torch.Tensor) else None


def fresh_start(xbms_used: bool = False):
    """(stage1_kwargs, stage2_kwargs) of a run that starts from scratch."""
    kw1 = {"start_epoch": 1, "init_opt_state": None, "init_gpa": None}
    kw2 = {"start_epoch": 0, "init_opt_state": None, "init_gpa": None}
    if xbms_used:
        kw2["init_xbms"] = None
    return kw1, kw2


def two_stage_resume(
    mgr: CheckpointManager,
    params: dict,
    s1_opt_paths: Callable[[dict], List[str]],
    s2_opt_paths: Callable[[dict], List[str]],
    gpa1_used: bool,
    gpa2_used: bool,
    xbms_used: bool = False,
    log: Callable[[str], None] = print,
):
    """Restore the newest two-stage checkpoint onto the device of `params`.

    Returns (params, done_stage, stage1_kwargs, stage2_kwargs): the kwargs
    feed run_stage{1,2} / run_mt_stage{1,2}'s start_epoch / init_opt_state
    / init_gpa (/ init_xbms when xbms_used). s{1,2}_opt_paths(params) give
    the leaf order of the stage's optimizer (checked against the saved
    one); the gpa*_used flags say whether the stage keeps a GPA sum, which
    the extras must then hold.

    A resumed run must use the SAME total epoch counts as the interrupted
    one: the GPA gaussian weights normalize over the planned epoch count
    (optim.gauss_weights). Under the manager's mesh every rank restores the
    same files and the restored parameters and optimizer state are checked
    to be identical on every rank."""
    kw1, kw2 = fresh_start(xbms_used)
    step = mgr.latest_epoch()
    if step is None:
        return params, 0, kw1, kw2
    dev = _device_of(params)
    restored = mgr.restore(step, device=dev)
    params = restored["params"]
    done = int(restored["stage"])
    e_in = int(restored["epoch_in_stage"])

    def _warn_missing(stage_no):
        log(f"[resume] WARNING: checkpoint step {step} has no extras companion (crash "
            f"between param save and extras save?); restarting stage {stage_no} from epoch "
            f"1 on the restored params — the trajectory will differ from an uninterrupted "
            f"run")

    def _extras(opt_paths, gpa_used, stage_no):
        extras = mgr.restore_extras(step, opt_paths(params), device=dev)
        if extras is None:
            _warn_missing(stage_no)
            return None
        if gpa_used != ("gpa" in extras):
            raise ValueError(f"checkpoint step {step}: stage {stage_no} "
                             f"{'keeps' if gpa_used else 'keeps no'} GPA sum, the extras "
                             f"{'lack' if gpa_used else 'hold'} one")
        return extras

    if done == 0 and e_in >= 0:
        extras = _extras(s1_opt_paths, gpa1_used, 1)
        if extras is not None:
            kw1 = {"start_epoch": e_in + 1, "init_opt_state": extras["optimizer"],
                   "init_gpa": extras.get("gpa")}
    elif done == 1 and e_in >= 0:
        extras = _extras(s2_opt_paths, gpa2_used, 2)
        if extras is not None:
            kw2 = {"start_epoch": e_in + 1, "init_opt_state": extras["optimizer"],
                   "init_gpa": extras.get("gpa")}
            if xbms_used:
                kw2["init_xbms"] = extras.get("xbms")
    if mgr.mesh is not None:
        check_replicated(mgr.mesh, [params, kw1["init_opt_state"], kw2["init_opt_state"]],
                         f"the checkpoint of step {step}")
    return params, done, kw1, kw2
