"""Checkpoint and resume (SURVEY.md §5 'checkpoint / resume').

The port of deepdenoiser_tpu/training/checkpoint.py on torch.save /
torch.load(weights_only=True) in place of orbax. Each checkpoint is a
directory `<dir>/<step>/` holding `state.pt` (the TrainState's state_dict:
step, parameters, optimizer, schedule, EMA) and `extra.json` (the data
iterator's state and the config). A save is written into a temporary
directory beside it and renamed into place, so a save killed half way
(SIGTERM, a lost machine) never leaves a checkpoint that loads half: the
previous ones stay, and the leftover temporary directory is ignored and
cleared by the next save. The newest `keep` checkpoints are kept.

With a data group (parallel/dist.py) rank 0 alone writes, and every rank
waits at a barrier until the save is in place; every rank restores from
the same newest checkpoint. The ranks hold the same state, so a
checkpoint does not say how many ranks wrote it: 1 and N ranks resume
each other's.

Saves are synchronous; `wait` and `close` keep the JAX manager's
interface. The port cannot read orbax checkpoints, nor the JAX package the
port's.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

from deepdenoiser_tpu_torch.training.train import TrainState

_TMP_PREFIX = ".tmp-"


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3, group=None):
        self._dir = Path(directory).absolute()
        self._dir.mkdir(parents=True, exist_ok=True)
        self._keep = keep
        self._group = group

    @property
    def directory(self) -> Path:
        return self._dir

    def steps(self) -> List[int]:
        return sorted(int(p.name) for p in self._dir.iterdir()
                      if p.is_dir() and p.name.isdigit() and (p / "state.pt").is_file())

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState, extra: Optional[Dict[str, Any]] = None) -> bool:
        """Write checkpoint `step`; False (nothing written) when it exists.
        With a data group, rank 0 writes and all ranks return after it."""
        if self._group is None:
            return self._write(step, state, extra)
        written = self._write(step, state, extra) if self._group.is_main else False
        self._group.barrier()
        return written

    def _write(self, step: int, state: TrainState, extra: Optional[Dict[str, Any]]) -> bool:
        final = self._dir / str(step)
        if final.exists():
            return False
        for p in self._dir.glob(f"{_TMP_PREFIX}*"):  # a killed save's leftovers
            shutil.rmtree(p, ignore_errors=True)
        tmp = self._dir / f"{_TMP_PREFIX}{step}-{os.getpid()}"
        tmp.mkdir()
        torch.save(state.state_dict(), tmp / "state.pt")
        (tmp / "extra.json").write_text(json.dumps(extra or {}))
        os.replace(tmp, final)
        for old in self.steps()[: -self._keep] if self._keep > 0 else []:
            shutil.rmtree(self._dir / str(old))
        return True

    def read_latest(self, map_location=None
                    ) -> Optional[Tuple[Dict[str, Any], Dict[str, Any]]]:
        """(the TrainState's state_dict, extra) of the newest checkpoint,
        loaded onto `map_location`, or None when there is none."""
        step = self.latest_step()
        if step is None:
            return None
        d = self._dir / str(step)
        state = torch.load(d / "state.pt", map_location=map_location, weights_only=True)
        extra_path = d / "extra.json"
        extra = json.loads(extra_path.read_text()) if extra_path.exists() else {}
        return state, extra

    def restore_latest(self, template: TrainState) -> Optional[Tuple[TrainState, Dict[str, Any]]]:
        """Load the newest checkpoint into `template` (in place, onto its
        device), or None when there is none."""
        got = self.read_latest(map_location=next(template.model.parameters()).device)
        if got is None:
            return None
        template.load_state_dict(got[0])
        return template, got[1]

    def wait(self) -> None:
        """Saves are synchronous: nothing is pending."""

    def close(self) -> None:
        self.wait()
