"""The render-root disk contract, as far as evaluation reads it.

The port's copy of the part of deepdenoiser_tpu/data/prepare.py that
inference/sequence.py needs (the shard writer comes with the loader):

    render_root/
      <frame_id>/
        ground_truth/        # pass-EXR dir at high spp
        spp<N>_seed<K>/      # noisy variants (any dir name != ground_truth)
"""

from __future__ import annotations

from pathlib import Path
from typing import List

GT_DIR = "ground_truth"


def _frame_dirs(render_root: Path) -> List[Path]:
    return sorted(
        p for p in render_root.iterdir() if p.is_dir() and (p / GT_DIR).is_dir()
    )
