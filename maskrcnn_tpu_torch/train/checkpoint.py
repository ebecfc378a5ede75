"""Training-state checkpoints (save / resume), port of
`maskrcnn_tpu/train/checkpoint.py`.

The whole `TrainState` (params, momentum trace, step) goes through
`torch.save` into `ckpt_<step>.pt` files (the JAX package writes flax
msgpack; the port has no flax), each written to a `.tmp` file and moved
into place, so a crash never leaves half a checkpoint. A restore is held
to a template state built from the same config and optimizer: any other
layer, weight, shape or dtype raises.
"""

from __future__ import annotations

import io
import json
import os
import threading

import torch

from maskrcnn_tpu_torch.train.step import TrainState


def _to_bytes(state: TrainState) -> bytes:
    """The state serialized now (device tensors copied to the host), so the
    caller may go on changing its state."""
    buf = io.BytesIO()
    torch.save({"params": state.params, "momentum": state.momentum,
                "step": int(state.step)}, buf)
    return buf.getvalue()


def _write_atomic(data: bytes, path: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _match(template, loaded, what: str) -> dict:
    """`loaded` ({layer: {weight: tensor}}) on the template's devices;
    raises unless it has the template's layers, weights, shapes and
    dtypes."""
    if not isinstance(loaded, dict) or set(loaded) != set(template):
        extra = sorted(set(loaded or {}) - set(template))[:5]
        missing = sorted(set(template) - set(loaded or {}))[:5]
        raise ValueError(f"checkpoint {what} do not match the template: "
                         f"missing {missing}, unexpected {extra}")
    out = {}
    for layer, ws in template.items():
        got = loaded[layer]
        if set(got) != set(ws):
            raise ValueError(f"checkpoint {what}[{layer!r}] has weights "
                             f"{sorted(got)}, the template {sorted(ws)}")
        out[layer] = {}
        for w, ref in ws.items():
            v = got[w]
            if tuple(v.shape) != tuple(ref.shape) or v.dtype != ref.dtype:
                raise ValueError(
                    f"checkpoint {what}[{layer!r}][{w!r}] is "
                    f"{tuple(v.shape)} {v.dtype}, the template "
                    f"{tuple(ref.shape)} {ref.dtype}")
            out[layer][w] = v.to(ref.device)
    return out


def save_train_state(state: TrainState, path: str) -> None:
    _write_atomic(_to_bytes(state), path)


def restore_train_state(template: TrainState, path: str) -> TrainState:
    """Restore into the structure of `template` (same config and
    optimizer), on its devices."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(obj, dict) or set(obj) != {"params", "momentum",
                                                 "step"}:
        raise ValueError(f"{path} is not a train-state checkpoint")
    return TrainState(_match(template.params, obj["params"], "params"),
                      _match(template.momentum, obj["momentum"], "momentum"),
                      int(obj["step"]))


class CheckpointManager:
    """Periodic training checkpoints: background writes, retention, resume.

    `save` serializes on the caller's thread (the device-to-host copy) and
    writes the bytes on a background thread, so the training loop does not
    wait on the disk; at most one write is in flight, and checkpoints past
    the newest `keep` are pruned. A failed write is raised by the next
    `wait()` or `save()`."""

    PREFIX, SUFFIX = "ckpt_", ".pt"

    def __init__(self, directory: str, keep: int = 3,
                 background: bool = True):
        self.directory = directory
        self.keep = max(keep, 1)
        self.background = background
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory,
                            f"{self.PREFIX}{step:08d}{self.SUFFIX}")

    def save(self, state: TrainState) -> str:
        """Serialize now, write (and prune) in the background. Returns the
        path the checkpoint has once the write lands."""
        data = _to_bytes(state)
        path = self._path(int(state.step))

        def write():
            try:
                _write_atomic(data, path)
                self._prune()
            except BaseException as e:  # raised by the next wait()/save()
                self._error = e

        self.wait()
        if self.background:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()
            self.wait()
        return path

    def wait(self) -> None:
        """Block until the write in flight has landed; raise its error
        (disk full, permissions) rather than report a phantom success."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                f"checkpoint write to {self.directory} failed") from err

    def _steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith(self.PREFIX) and name.endswith(self.SUFFIX):
                try:
                    out.append(int(name[len(self.PREFIX):-len(self.SUFFIX)]))
                except ValueError:
                    continue
        return sorted(out)

    def _prune(self) -> None:
        for step in self._steps()[:-self.keep]:
            try:
                os.remove(self._path(step))
            except OSError:
                pass

    def latest_step_path(self) -> tuple[int, str] | None:
        """(step, path) of the newest checkpoint, or None if there is
        none."""
        steps = self._steps()
        if not steps:
            return None
        return steps[-1], self._path(steps[-1])

    def restore_latest(self, template: TrainState) -> TrainState | None:
        self.wait()
        found = self.latest_step_path()
        if found is None:
            return None
        return restore_train_state(template, found[1])


class MetricsLogger:
    """Append-only JSONL training metrics, one line per logged step."""

    def __init__(self, path: str | None):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log(self, step: int, metrics: dict, wall_s: float) -> None:
        if not self.path:
            return
        row = {"step": step, "wall_s": round(wall_s, 3)}
        row.update({k: float(v) for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")
