"""Port bench: 512px layout-grounded generation throughput on one card
(the port's counterpart of the JAX package's bench.py).

    python -m layoutllm_t2i_torch.cli.bench                 # on the card
    python -m layoutllm_t2i_torch.cli.bench --small --device cpu --batch 2 --iters 1

Runs the flagship pipeline (SD-1.4-width relation-aware UNet, PLMS-50, CFG
7.5, alpha (0.3, 0, 0.7), 30 grounding slots, 5 relation slots, VAE decode
in chunks of 8) with random weights from seed 0 (bf16 on the card, f32 on
the CPU) and measures steady-state images per second.

The default invocation measures both headlines on the same bundle and the
same timed noise, as bench.py does: the exact PLMS-50 configuration
(``value``), then the fast preset of pipeline/presets.py (``fast_*``), with
``fast_psnr_vs_exact_db``, the PSNR between the two runs' last images,
measured live. Any non-default knob (--fast, --no_fast, --latency, --int8,
a sampler, step count, guidance interval or encoder cache) measures that
one configuration only; --trace alone stays dual.

Timing: ``iters`` generations of ``batch`` requests on one noise stack
(seed 7) warm up, then ``iters`` more on a second stack (seed 1234) are
timed back to back, each image batch reduced to a scalar on the device and
the device synchronised inside the timed region; the last images are
fetched after it. FLOPs come from utils/flops.py (the analytic count of one
sample_latents call); ``flops_per_image`` is in TFLOP an image and ``mfu``
a fraction of utils/flops.py peak_tflops(), as bench.py reports them.

Prints ONE JSON line, last:
  {"metric": "images_per_sec_per_chip", "value": N, "unit": "img/s",
   "tflops_per_sec", "mfu", "peak_tflops", "flops_per_image", "device",
   "peak_mem_gib", and in dual mode "fast_value", "fast_psnr_vs_exact_db",
   "fast_tflops_per_sec", "fast_mfu", "fast_flops_per_image" (or
   "fast_error")}
There is no ``vs_baseline``: BASELINE.md's target is a TPU's.

``--sharded`` splits the batch's rows over every rank of the torchrun group
(InferencePipeline.sample_latents_sharded; ``torchrun --nproc_per_node N
-m layoutllm_t2i_torch.cli.bench --sharded``): ``value`` is the whole
batch's images a second and ``mfu`` counts the world size's cards, as
bench.py does (bench.py:294). Only rank 0 prints.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

PROMPT = "a dog chasing a frisbee in a park"
LAYOUT = ([[0.1, 0.3, 0.5, 0.9], [0.55, 0.2, 0.9, 0.5]], ["dog", "frisbee"])
RELATIONS = ["dog chase frisbee"]
WARMUP_SEED, TIMED_SEED = 7, 1234


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--sampler", type=str, default="plms",
                    choices=["plms", "ddim", "dpm"],
                    help="dpm = DPM-Solver++(2M): PLMS-50-class quality at "
                         "~20 steps")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--small", action="store_true",
                    help="tiny model for CPU smoke")
    ap.add_argument("--guidance", type=float, default=7.5)
    ap.add_argument("--vae_chunk", type=int, default=8,
                    help="decode the VAE in chunks of this batch size "
                         "(peak-memory cap; 0 = whole batch at once)")
    ap.add_argument("--trace", type=str, default=None,
                    help="after the timed run, profile one more timed run "
                         "of each mode into this directory (DIR/exact, "
                         "DIR/fast in dual mode) and print the device's "
                         "idle share")
    ap.add_argument("--latency", action="store_true",
                    help="report the mean single-image latency instead of "
                         "throughput (forces batch 1)")
    ap.add_argument("--int8", action="store_true",
                    help="weight-only int8 UNet (ops/quant.py); "
                         "LLT2I_FFN_INT8=1 routes its FF sites to K7")
    ap.add_argument("--cache_encoder", type=int, default=0,
                    help="encoder propagation interval N (arXiv:2312.09608; "
                         "approximate; 0/1 = exact)")
    ap.add_argument("--cfg_interval", type=str, default=None,
                    help="LO,HI step fractions where CFG applies "
                         "(arXiv:2404.07724)")
    ap.add_argument("--sharded", action="store_true",
                    help="shard the prompt batch over every rank of the "
                         "torchrun group (prompt-parallel)")
    ap.add_argument("--fast", action="store_true",
                    help="the fast preset only: DPM-Solver++ 15 steps + "
                         "CFG interval 0,0.75 + encoder cache 2; explicit "
                         "flags override its pieces")
    ap.add_argument("--no_fast", action="store_true",
                    help="skip the fast preset's measurement in the default "
                         "invocation")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; default the CUDA card")
    return ap.parse_args(argv)


def is_dual(args) -> bool:
    """bench.py's rule: the plain default invocation measures the exact
    headline and the fast preset; any explicit A/B knob opts out."""
    return not (args.fast or args.no_fast or args.latency or args.int8
                or args.sharded or args.sampler != "plms" or args.steps != 50
                or args.cfg_interval is not None or args.cache_encoder != 0)


def psnr_db(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float32)
                         - np.asarray(b, np.float32)) ** 2))
    return float("inf") if mse == 0 else 10.0 * float(np.log10(1.0 / mse))


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or the
    device type off the card."""
    if device.type != "cuda":
        return device.type
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return out[0] if out else torch.cuda.get_device_name(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Bench:
    """The bench's bundle, inputs and timing for one set of flags."""

    def __init__(self, args):
        from ..device import resolve_device
        from ..pipeline import presets
        from ..pipeline.loaders import quantize_unet_int8, random_models

        self.mesh = None
        if args.sharded:
            from ..parallel.mesh import make_mesh, row_block

            self.mesh = make_mesh(device=args.device)
            row_block(args.batch, self.mesh)   # raises before any model
        self.args = args
        self.dual = is_dual(args)
        self.metric_suffix = ""
        if args.fast:
            if args.sampler == "plms":
                args.sampler = presets.FAST_SAMPLER
                if args.steps == 50:
                    args.steps = presets.FAST_STEPS
            if args.cfg_interval is None:
                args.cfg_interval = presets.fast_cfg_interval_str()
            if args.cache_encoder == 0:
                args.cache_encoder = presets.FAST_CACHE_ENCODER
            self.metric_suffix = "_fast"
        if args.latency:
            args.batch = 1
        self.device = (self.mesh.device if self.mesh is not None
                       else resolve_device(args.device))
        models = random_models(small=args.small, device=self.device, seed=0)
        if args.int8:
            models = quantize_unet_int8(models)
        self.models = models
        b = args.batch
        self.pipe = self.make_pipe()
        # conditioning is built once, outside the timed region
        self.cond = self.pipe.build_cond([PROMPT] * b, [LAYOUT] * b,
                                         [RELATIONS] * b)
        if self.mesh is not None:
            from ..parallel.mesh import replicate

            self.cond = replicate(self.mesh, self.cond)
        self.noises = self.make_noises(WARMUP_SEED)
        self.noises_timed = self.make_noises(TIMED_SEED)

    def make_pipe(self, **overrides):
        from ..pipeline.inference import InferencePipeline

        a = self.args
        kw = dict(steps=a.steps, sampler=a.sampler, guidance_scale=a.guidance,
                  alpha_type=(0.3, 0.0, 0.7), vae_chunk=a.vae_chunk or None,
                  encoder_cache_interval=a.cache_encoder,
                  cfg_interval=a.cfg_interval)
        kw.update(overrides)
        return InferencePipeline(self.models, **kw)

    def fast_pipe(self):
        from ..pipeline import presets

        return self.make_pipe(steps=presets.FAST_STEPS,
                              sampler=presets.FAST_SAMPLER,
                              cfg_interval=presets.FAST_CFG_INTERVAL,
                              encoder_cache_interval=presets.FAST_CACHE_ENCODER)

    def make_noises(self, seed: int):
        """``iters`` noise batches from one generator seeded with ``seed``."""
        cfg = self.models.unet_cfg
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        shape = (self.args.batch, cfg.image_size, cfg.image_size,
                 cfg.in_channels)
        return [torch.randn(shape, generator=gen, device=self.device)
                for _ in range(self.args.iters)]

    def run_all(self, pipe, noises):
        """One generation a noise batch, back to back; each image batch
        reduced to a scalar on the device, the host waiting once for all.
        Returns the last images, still on the device."""
        sums, img = [], None
        for nz in noises:
            img = (pipe.sample_latents(self.cond, nz) if self.mesh is None
                   else pipe.sample_latents_sharded(self.mesh, self.cond, nz))
            sums.append(img.float().sum())
        float(torch.stack(sums).sum())   # waits for the device
        return img

    def measure(self, pipe, trace_dir=None):
        """Warm-up, the timed run, FLOPs and MFU of one configuration.
        Returns (record, the timed run's last images as a numpy array)."""
        from ..utils.flops import generation_flops, mfu, peak_tflops
        from ..utils.profiling import device_profile

        a, dev = self.args, self.device
        flops = generation_flops(pipe, a.batch)["total"] * a.iters
        t_c = time.perf_counter()
        self.run_all(pipe, self.noises)
        print(f"[bench] warm-up {time.perf_counter() - t_c:.1f}s", flush=True)
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        img_last = self.run_all(pipe, self.noises_timed)
        _sync(dev)
        dt = time.perf_counter() - t0
        img_last = img_last.cpu().numpy()   # untimed: already synchronised
        cards = 1 if self.mesh is None else self.mesh.size
        rec = {"imgs_per_sec": a.batch * a.iters / dt, "dt": dt,
               "tflops_per_sec": flops / dt / 1e12,
               "mfu": mfu(flops, dt, cards),
               "peak_tflops": peak_tflops(),
               "flops_per_image": flops / (a.batch * a.iters) / 1e12,
               "peak_mem_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                                if dev.type == "cuda" else None)}
        if self.mesh is not None:
            rec["ranks"] = self.mesh.size
        if trace_dir:
            noises_tr = self.make_noises(99)
            prof = device_profile(lambda: self.run_all(pipe, noises_tr),
                                  trace_dir, on_card=dev.type == "cuda")
            print(f"[bench] trace {trace_dir}: {json.dumps(prof)}", flush=True)
            rec["trace"] = prof
        return rec, img_last

    def run(self):
        """(the JSON record, {mode: the timed run's last images})."""
        a = self.args
        trace_exact = (a.trace + "/exact" if a.trace and self.dual else a.trace)
        rec, img_exact = self.measure(self.pipe, trace_dir=trace_exact)
        images = {"exact": img_exact}
        imgs_per_sec, dt = rec.pop("imgs_per_sec"), rec.pop("dt")
        card = card_line(self.device)
        if a.latency:
            out = {"metric": "image_latency_steady_state_mean"
                             + self.metric_suffix,
                   "value": dt / a.iters, "unit": "s/img", **rec,
                   "device": card}
            return out, images
        out = {"metric": "images_per_sec_per_chip" + self.metric_suffix,
               "value": imgs_per_sec, "unit": "img/s", **rec, "device": card}
        if self.dual:
            # second headline: the fast preset on the same weights and the
            # same timed noise; a failure there keeps the exact headline
            try:
                frec, img_fast = self.measure(
                    self.fast_pipe(),
                    trace_dir=a.trace + "/fast" if a.trace else None)
                images["fast"] = img_fast
                out.update(fast_value=frec["imgs_per_sec"],
                           fast_psnr_vs_exact_db=psnr_db(img_fast, img_exact))
                for k in ("tflops_per_sec", "mfu", "flops_per_image",
                          "peak_mem_gib", "trace"):
                    if k in frec:
                        out["fast_" + k] = frec[k]
            except Exception as e:
                out["fast_error"] = f"{type(e).__name__}: {e}"[:300]
        return out, images


def main(argv=None):
    from ..parallel.mesh import is_primary

    out, _ = Bench(parse_args(argv)).run()
    if is_primary():
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
