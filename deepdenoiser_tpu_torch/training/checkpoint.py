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
    def __init__(self, directory: str | Path, keep: int = 3):
        self._dir = Path(directory).absolute()
        self._dir.mkdir(parents=True, exist_ok=True)
        self._keep = keep

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
        """Write checkpoint `step`; False (nothing written) when it exists."""
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

    def restore_latest(self, template: TrainState) -> Optional[Tuple[TrainState, Dict[str, Any]]]:
        """Load the newest checkpoint into `template` (in place, onto its
        device), or None when there is none."""
        step = self.latest_step()
        if step is None:
            return None
        d = self._dir / str(step)
        dev = next(template.model.parameters()).device
        template.load_state_dict(torch.load(d / "state.pt", map_location=dev, weights_only=True))
        extra_path = d / "extra.json"
        extra = json.loads(extra_path.read_text()) if extra_path.exists() else {}
        return template, extra

    def wait(self) -> None:
        """Saves are synchronous: nothing is pending."""

    def close(self) -> None:
        self.wait()
