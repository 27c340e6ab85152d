"""Time diffusion training on COCO-layout data against synthetic batches.

Run on the card from the root of a checkout:
  python3 layoutllm_t2i_torch/cli/loader_timing.py [--steps 12] [--rounds 2]
It writes chip_smoke.py's COCO-2014 fixture (``coco_fixture``: 16
captioned PNGs of assorted sizes) under ``build/loader_timing``, builds
the kernels, and runs ``cli/train_diffusion.py main`` at full width,
``--mixed_precision``, batch 8, ``--steps`` steps, in turns on
``--coco_root`` (data/coco.py: 4 decode threads, Pillow's bicubic resize
in numpy) and on ``--synthetic`` (numpy draws on the training thread),
``--rounds`` times each. It prints one JSON line a run: the card, the
seconds of each step (the trainer logs every step here), their mean from
the third step on, and the seconds each step waited for its batch (the
trainer's ``next()`` on its data).
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import shutil
import sys
import time


def timed_batches(make, waits: list):
    """``make`` with each ``next()`` on what it returns timed into ``waits``."""
    def wrapped(*args, **kwargs):
        it = iter(make(*args, **kwargs))
        try:
            while True:
                t0 = time.perf_counter()
                batch = next(it)
                waits.append(time.perf_counter() - t0)
                yield batch
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()
    return wrapped


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from layoutllm_t2i_torch.cli import train_diffusion

    if not torch.cuda.is_available():
        print("loader_timing: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = os.path.join("build", "loader_timing")
    shutil.rmtree(work, ignore_errors=True)
    waits: list = []
    saved = {name: getattr(train_diffusion, name) for name in
             ("coco_layout_batches", "synthetic_layout_batches", "TrainerConfig")}
    train_diffusion.coco_layout_batches = timed_batches(
        saved["coco_layout_batches"], waits)
    train_diffusion.synthetic_layout_batches = timed_batches(
        saved["synthetic_layout_batches"], waits)
    train_diffusion.TrainerConfig = functools.partial(saved["TrainerConfig"],
                                                      log_every=1)
    try:
        with cs.route_env(cs.DEFAULT):
            cs.phase_build()
            fx = cs.coco_fixture(work)
            for i in range(2 * args.rounds):
                mode = ("coco", "synthetic")[i % 2]
                waits.clear()
                out = os.path.join(work, f"out{i}")
                data = (["--coco_root", fx["root"]] if mode == "coco"
                        else ["--synthetic"])
                t0 = time.perf_counter()
                train_diffusion.main(data + [
                    "--mixed_precision", "--batch_size", str(cs.TRAIN_BATCH),
                    "--total_iters", str(args.steps), "--warmup_steps", "0",
                    "--save_every_iters", str(10 ** 9), "--output_root", out,
                    "--name", "t"])
                wall = time.perf_counter() - t0
                with open(os.path.join(out, "t", "tag00", "metrics.jsonl")) as f:
                    each = [json.loads(line)["sec_per_iter"] for line in f]
                print(json.dumps({
                    "card": cs.nvidia_smi_line(), "mode": mode,
                    "steps": args.steps, "wall_s": wall, "s_per_step_each": each,
                    "s_per_step_from_3rd": sum(each[2:]) / max(len(each) - 2, 1),
                    "wait_s_each": waits[:len(each)]}), flush=True)
                shutil.rmtree(out, ignore_errors=True)
    finally:
        for name, value in saved.items():
            setattr(train_diffusion, name, value)
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
