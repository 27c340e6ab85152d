"""The ``--fast`` serving preset (layoutllm_t2i_tpu/pipeline/presets.py).

Every surface of the port that exposes ``--fast`` (cli/serve.py,
chip_smoke.py's phase ``fast``) reads these constants, so the preset is
decided in one place: DPM-Solver++(2M) at 15 steps, classifier-free
guidance only on the first three quarters of the steps (0, 0.75), and the
UNet encoder re-run on every 2nd step. int8 is not part of it. The values
are the JAX package's; the port keeps its own copy.
"""
from __future__ import annotations

FAST_SAMPLER = "dpm"
FAST_STEPS = 15
FAST_CFG_INTERVAL = (0.0, 0.75)
FAST_CACHE_ENCODER = 2


def fast_cfg_interval_str() -> str:
    return f"{FAST_CFG_INTERVAL[0]},{FAST_CFG_INTERVAL[1]}"


def apply_fast_preset(args):
    """Expand --fast onto an argparse namespace, leaving any explicitly
    passed --sampler/--steps/--cfg_interval/--cache_encoder untouched
    (argparse defaults are plms/None/None/0, so a non-default value means
    the user chose it)."""
    if args.sampler == "plms":
        args.sampler = FAST_SAMPLER
        if args.steps is None:
            args.steps = FAST_STEPS
    if args.cfg_interval is None:
        args.cfg_interval = fast_cfg_interval_str()
    if args.cache_encoder == 0:
        args.cache_encoder = FAST_CACHE_ENCODER
    return args
