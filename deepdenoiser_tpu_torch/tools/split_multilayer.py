"""Split Blender multilayer EXRs into per-pass EXR files next to each.

    python -m deepdenoiser_tpu_torch.tools.split_multilayer \\
        renders/frame0001/spp4_seed0/frame.exr ...

The port of tools/split_multilayer.py (data/exr.load_multilayer_exr, then
save_frame_dir with Cycles' file names). Optional: the ingest reads
multilayer files directly (cli's --frame takes one); splitting is for
inspection or partial-pass workflows. Host work only, so it takes no
--device, as prepare-data takes none.
"""

import sys
from pathlib import Path
from typing import List

from deepdenoiser_tpu_torch.data import exr


def main(argv: List[str] | None = None) -> int:
    paths = sys.argv[1:] if argv is None else argv
    if not paths:
        print(__doc__)
        return 2
    for arg in paths:
        path = Path(arg)
        passes_dict = exr.load_multilayer_exr(path)
        exr.save_frame_dir(path.parent, passes_dict, cycles_names=True)
        print(f"{path}: split {len(passes_dict)} passes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
