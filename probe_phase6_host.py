"""Is a frame phase of chip_smoke.py slowed by the host work its spawned
worker process does beside the card's phases?

    python3 probe_phase6_host.py [--phase 6|9]

On one CUDA card: the phase alone (6: the flagship-max group frame, the
default; 9: the flagship joint frame), then beside each of the worker's
tasks in turn (bench.py's two 1080p holdout families, the 1080p frame as a
multilayer EXR, the input pipeline's corpus, the EXR codec's read and
write turns of phase 26), each task in a fresh spawned process, then the
phase alone again. Prints each run's lines and each task's wall and CPU
seconds (CPU summed over the task's threads). A script of the repo root,
not part of the package; imports chip_smoke.
"""
import argparse
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
          "corpus": cs._pipe_corpus, "exr": cs._exr_turns}[name]
    fn(*args)
    c1 = os.times()
    cpu = (c1.user - c0.user) + (c1.system - c0.system)
    return name, time.perf_counter() - t0, cpu


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--phase", type=int, choices=(6, 9), default=6)
    args = ap.parse_args()
    card = cs.phase_card()
    cs.phase_build()
    from deepdenoiser_tpu_torch.data import exr
    clean, noisy = cs._fourier_frame()
    frame_dir = cs.WORK / "fourier_1080p_spp4"
    exr.save_frame_dir(frame_dir, noisy)
    frame = {"clean": clean, "noisy": noisy, "dir": frame_dir}
    if args.phase == 6:
        def run():
            cs.phase_flagship_max(frame, card)
    else:
        def run():
            cs.phase_preset("flagship", "flagship_ema_f16.npz", frame, card,
                            kernel_launches_per_frame=0, check_fp32=True, timed_frames=5)
    print("=== alone", flush=True)
    run()
    cs.MULTILAYER_EXR.parent.mkdir(parents=True, exist_ok=True)
    for task, task_args in (("holdouts", (cs.FRAME_H, cs.FRAME_W)),
                            ("multilayer", (cs.MULTILAYER_EXR, cs.FRAME_H, cs.FRAME_W)),
                            ("corpus", (cs.TRAIN_CROP,)),
                            ("exr", (cs.MULTILAYER_EXR,))):
        with concurrent.futures.ProcessPoolExecutor(
                1, mp_context=multiprocessing.get_context("spawn")) as pool:
            pool.submit(time.sleep, 0).result()  # the worker is up
            fut = pool.submit(timed, task, *task_args)
            time.sleep(2)
            print(f"=== beside {task}", flush=True)
            run()
            print(f"=== {task} (name, wall s, cpu s of all threads): {fut.result()}", flush=True)
    print("=== alone again", flush=True)
    run()
    print(f"cpus {os.cpu_count()} affinity {len(os.sched_getaffinity(0))}")


if __name__ == "__main__":
    main()
