"""Is the group frame of chip_smoke.py phase 6 (flagship-max) slowed by the
host work its spawned worker process does beside the card's phases?

    python3 probe_phase6_host.py

On one CUDA card: phase 6 alone, then beside each of the worker's tasks
in turn (bench.py's two 1080p holdout families, the 1080p frame as a
multilayer EXR, the input pipeline's corpus), each task in a fresh spawned
process, then phase 6 alone again. Prints each phase 6 run's lines and
each task's wall and CPU seconds (CPU summed over the task's threads). A
script of the repo root, not part of the package; imports chip_smoke.
"""
import concurrent.futures
import multiprocessing
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import chip_smoke as cs  # noqa: E402


def timed(name, *args):
    t0, c0 = time.perf_counter(), os.times()
    fn = {"holdouts": cs._holdout_frames, "multilayer": cs._write_multilayer,
          "corpus": cs._pipe_corpus}[name]
    fn(*args)
    c1 = os.times()
    cpu = (c1.user - c0.user) + (c1.system - c0.system)
    return name, time.perf_counter() - t0, cpu


def main():
    card = cs.phase_card()
    cs.phase_build()
    from deepdenoiser_tpu_torch.data import exr
    clean, noisy = cs._fourier_frame()
    frame_dir = cs.WORK / "fourier_1080p_spp4"
    exr.save_frame_dir(frame_dir, noisy)
    frame = {"clean": clean, "noisy": noisy, "dir": frame_dir}
    print("=== alone", flush=True)
    cs.phase_flagship_max(frame, card)
    cs.MULTILAYER_EXR.parent.mkdir(parents=True, exist_ok=True)
    for task, args in (("holdouts", (cs.FRAME_H, cs.FRAME_W)),
                       ("multilayer", (cs.MULTILAYER_EXR, cs.FRAME_H, cs.FRAME_W)),
                       ("corpus", (cs.TRAIN_CROP,))):
        with concurrent.futures.ProcessPoolExecutor(
                1, mp_context=multiprocessing.get_context("spawn")) as pool:
            pool.submit(time.sleep, 0).result()  # the worker is up
            fut = pool.submit(timed, task, *args)
            time.sleep(2)
            print(f"=== beside {task}", flush=True)
            cs.phase_flagship_max(frame, card)
            print(f"=== {task} (name, wall s, cpu s of all threads): {fut.result()}", flush=True)
    print("=== alone again", flush=True)
    cs.phase_flagship_max(frame, card)
    print(f"cpus {os.cpu_count()} affinity {len(os.sched_getaffinity(0))}")


if __name__ == "__main__":
    main()
