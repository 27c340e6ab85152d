"""Serving CLI: the micro-batched HTTP generation server
(layoutllm_t2i_tpu/cli/serve.py).

    python -m layoutllm_t2i_torch.cli.serve --ckpt gligen.pth --port 8501 \\
        --batch 8 --max_delay_ms 80 --fast

    curl -s localhost:8501/generate -d '{"prompt": "a dog in a park",
        "layout": [{"phrase": "dog", "box": [0.2, 0.4, 0.5, 0.9]}]}' \\
        -o out.png
    curl -s localhost:8501/metrics

The model runs on the card (``--device``, default CUDA); ``--small
--device cpu`` serves a tiny random-weight model on the CPU for smoke
tests. Requests coalesce into fixed ``--batch`` dispatches (serving/
batcher.py). ``--fast`` is the preset of pipeline/presets.py. ``--tp``
(tensor-parallel latency mode) is refused: parallel/ is not ported.
"""
from __future__ import annotations

import argparse

from ..pipeline.presets import apply_fast_preset


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", type=str, default=None,
                    help="a reference GLIGEN .pth (random weights without)")
    ap.add_argument("--small", action="store_true",
                    help="tiny random-weight models for smoke runs")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; default the CUDA card")
    ap.add_argument("--host", type=str, default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8501)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--max_delay_ms", type=float, default=80.0)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--sampler", type=str, default="plms",
                    choices=["plms", "ddim", "dpm"],
                    help="dpm = DPM-Solver++(2M), PLMS-50-class at ~15-20 "
                         "steps")
    ap.add_argument("--guidance_scale", type=float, default=7.5)
    ap.add_argument("--no_warmup", action="store_true")
    ap.add_argument("--tp", action="store_true",
                    help="tensor-parallel latency mode (not ported)")
    ap.add_argument("--int8", action="store_true",
                    help="weight-only int8 UNet (ops/quant.py); "
                         "LLT2I_FFN_INT8=1 routes its FF sites to K7")
    ap.add_argument("--cache_encoder", type=int, default=0,
                    help="encoder propagation interval (approximate, "
                         "arXiv:2312.09608; 0/1 = exact)")
    ap.add_argument("--cfg_interval", type=str, default=None,
                    help="LO,HI step fractions where CFG applies "
                         "(arXiv:2404.07724)")
    ap.add_argument("--fast", action="store_true",
                    help="speed preset (pipeline/presets.py): DPM-Solver++ "
                         "15 steps + guidance interval 0,0.75 + encoder "
                         "cache 2; explicit --sampler/--steps/--cfg_interval/"
                         "--cache_encoder override its pieces")
    return ap.parse_args(argv)


def build_server(args):
    """The GenerationServer the flags describe, warming up in the
    background. Returns (server, steps)."""
    if args.tp:
        raise NotImplementedError(
            "--tp: tensor-parallel serving is not ported (parallel/, "
            "ROADMAP.md Queue 1)")
    if args.fast:
        apply_fast_preset(args)

    from ..pipeline.inference import InferencePipeline, parse_cfg_interval
    from ..pipeline.loaders import (load_models_from_gligen_ckpt,
                                    quantize_unet_int8, random_models)
    from ..serving.server import GenerationServer

    cfg_interval = parse_cfg_interval(args.cfg_interval)
    if args.ckpt:
        models = load_models_from_gligen_ckpt(args.ckpt, device=args.device)
    else:
        models = random_models(small=args.small, device=args.device)
    if args.int8:
        models = quantize_unet_int8(models)
    steps = args.steps or (8 if args.small else 50)
    pipe = InferencePipeline(models, steps=steps, sampler=args.sampler,
                             guidance_scale=args.guidance_scale,
                             encoder_cache_interval=args.cache_encoder,
                             cfg_interval=cfg_interval)
    batch = args.batch or 4
    srv = GenerationServer(pipe, batch_size=batch,
                           max_delay_ms=args.max_delay_ms, host=args.host,
                           port=args.port, warmup=not args.no_warmup)
    return srv, steps


def main(argv=None):
    args = parse_args(argv)
    srv, steps = build_server(args)
    print(f"serving on {args.host}:{srv.port} (batch={srv.batcher.batch_size}, "
          f"steps={steps}, sampler={args.sampler})", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.shutdown()


if __name__ == "__main__":
    main()
