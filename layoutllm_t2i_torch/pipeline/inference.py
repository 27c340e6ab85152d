"""Layout-grounded generation pipeline (layoutllm_t2i_tpu/pipeline/
inference.py; reference GLIGEN interface.py).

CLIP text encode -> PositionNet grounding tokens (once, outside the step
loop) -> PLMS, DDIM or DPM-Solver++ over a doubled-batch CFG denoiser ->
VAE decode; the guidance interval and the encoder cache are opt-in
(pipeline/presets.py bundles them as the fast preset). Host code
builds fixed-shape (max_objs=30, max_relas) tensors from the ragged layout,
mirroring interface.py:157-290. Public tensors keep the JAX package's
shapes: noise (B, S, S, 4) with S the UNet config's ``image_size`` (64:
images (B, 512, 512, 3) in [0, 1]; 96, SD-1.4 at 768^2: (B, 768, 768,
3)), as the JAX pipeline samples at ``unet_cfg.image_size``.

The conditioning dict may carry the extra grounding of the other GLIGEN
modalities and inpainting, NHWC as in the JAX package:
``extra_grounding`` (text_image: text_masks, image_masks,
image_embeddings; map: cond_map, map_mask), ``grounding_extra`` (a
downsampled condition map, extra UNet input channels), ``inpainting_extra``
(an inpaint_mode UNet's masked latent and mask) and ``inpaint_mask`` /
``inpaint_z0`` (the sampler's known-region blend; the encoder cache is off
under it, since the blend must flow through the encoder every step).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, default_dtype, resolve_device
from ..diffusion.samplers import (InpaintBlend, StepTables, ddim_sample,
                                  dpm_sample, make_step_tables, plms_sample)
from ..models.clip_text import CLIPTextConfig, clip_text_apply
from ..models.unet import UNetConfig, apply_position_net, unet_apply
from ..models.vae import VAEConfig, decode as vae_decode
from ..ops.nn import nchw_to_nhwc, nhwc_to_nchw
from ..ops.schedules import DDPMSchedule
from ..parallel.collectives import all_gather
from ..parallel.mesh import replicate, row_block, shard_batch
from ..parallel.tp import tp_mode
from ..utils.buckets import pad_rows_pow2
from ..utils.trees import override_subtree


@dataclasses.dataclass
class GligenModels:
    """Bundle of the four modules (cf. interface.py load_all_models)."""

    unet_cfg: UNetConfig
    unet_params: Any
    vae_cfg: VAEConfig
    vae_params: Any
    clip_cfg: CLIPTextConfig
    clip_params: Any
    schedule: DDPMSchedule
    tokenizer: Any
    # SD first-conv weights for the alpha==0 restore (openaimodel.py:393-408):
    # {'weight' (OIHW), 'bias'} or None to disable the swap
    sd_first_conv: Optional[dict] = None
    max_objs: int = 30
    max_relas: int = 5
    # None: the card (or an error without one) and its default dtype
    compute_dtype: Optional[torch.dtype] = None
    device: DeviceLike = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.compute_dtype = self.compute_dtype or default_dtype(self.device)


# ---------------------------------------------------------------------------
# host-side fixed-shape batch prep


def pack_layout(boxes: Sequence[Sequence[float]], phrase_embeddings: np.ndarray,
                max_objs: int = 30) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Ragged layout -> (boxes (MO,4), masks (MO,), embeddings (MO,768)).
    boxes are normalized xyxy; mirrors interface.py prepare_batch:157-219."""
    n = min(len(boxes), max_objs)
    out_boxes = np.zeros((max_objs, 4), dtype=np.float32)
    out_masks = np.zeros((max_objs,), dtype=np.float32)
    dim = phrase_embeddings.shape[-1] if len(phrase_embeddings) else 768
    out_emb = np.zeros((max_objs, dim), dtype=np.float32)
    if n:
        out_boxes[:n] = np.asarray(boxes, dtype=np.float32)[:n]
        out_masks[:n] = 1.0
        out_emb[:n] = phrase_embeddings[:n]
    return out_boxes, out_masks, out_emb


def convert_xywh_to_ltrb(box):
    x, y, w, h = box
    return [x, y, x + w, y + h]


def convert_xcycwh_to_ltrb(box):
    xc, yc, w, h = box
    return [xc - w / 2, yc - h / 2, xc + w / 2, yc + h / 2]


# ---------------------------------------------------------------------------
# device-side programs


@torch.no_grad()
def encode_texts_bucketed(models: GligenModels, texts: List[str]):
    """(last hidden, pooled) CLIP outputs of ``texts``, with the batch
    padded to a power-of-two bucket (the JAX package's compile-cache
    policy, kept for parity) and the padding rows sliced off."""
    ids = models.tokenizer(texts)
    n = ids.shape[0]
    ids = torch.from_numpy(pad_rows_pow2(ids).astype(np.int64)).to(models.device)
    hidden, pooled = clip_text_apply(models.clip_params, models.clip_cfg, ids)
    return hidden[:n], pooled[:n]


def precompute_grounding_tokens(models: GligenModels, unet_params, cond,
                                use_cfg: bool) -> torch.Tensor:
    """Grounding tokens are step-invariant: computed once before sampling
    (the reference recomputes them per step, openaimodel.py:426). Returns
    the (2B or B, N, C) tokens in make_cfg_denoiser's batch layout. The
    null half's extra grounding is all zeros: a map's mask is 0 (its tokens
    the null feature), and so are the image masks."""
    cfg, pn = models.unet_cfg, unet_params["position_net"]
    eg = cond.get("extra_grounding")
    objs_c = apply_position_net(pn, cfg, cond["boxes"], cond["masks"],
                                cond["phrase_embeddings"], eg)
    if not use_cfg:
        return objs_c
    eg_null = (None if eg is None
               else {k: torch.zeros_like(v) for k, v in eg.items()})
    objs_u = apply_position_net(pn, cfg, torch.zeros_like(cond["boxes"]),
                                torch.zeros_like(cond["masks"]),
                                torch.zeros_like(cond["phrase_embeddings"]),
                                eg_null)
    return torch.cat([objs_c, objs_u])


def parse_cfg_interval(spec) -> Optional[Tuple[float, float]]:
    """A guidance interval: "LO,HI" or a 2-sequence of step fractions,
    0 <= LO < HI; None for None or "". Shared by every CLI so the
    validation lives in one place."""
    if spec is None or spec == "":
        return None
    parts = spec.split(",") if isinstance(spec, str) else list(spec)
    try:
        vals = tuple(float(v) for v in parts)
    except (TypeError, ValueError):
        raise ValueError(f"cfg_interval: want 'LO,HI' fractions, got {spec!r}")
    if len(vals) != 2:
        raise ValueError(f"cfg_interval: want exactly 2 values, got {spec!r}")
    lo, hi = vals
    if not (0.0 <= lo < hi):
        raise ValueError(
            f"cfg_interval: need 0 <= LO < HI (got {lo}, {hi}); a reversed "
            "interval would silently disable guidance everywhere")
    return vals


def make_cfg_denoiser(models: GligenModels, guidance_scale: float,
                      cfg_override: Optional[bool] = None):
    """Returns denoise(params, sd_conv, cond, x, t, fuser_scale, use_sd,
    skip_gated=False, cache=None, is_key=None) with classifier-free
    guidance as one doubled batch (the reference issues two UNet calls,
    plms.py:115-124). x is the (B, 4, h, w) channels_last f32 latent; the
    result is f32 eps.

    ``cfg_override=False`` forces the cond-only batch whatever the scale:
    the guidance interval runs the steps outside it through this variant.

    Encoder-propagation mode (``is_key`` not None) returns (eps, cache): a
    key step runs the full UNet and returns its encoder cache; any other
    step runs the middle block and the decoder on ``cache``, which must
    come from a key step at the same batch."""
    cfg = models.unet_cfg
    dtype = models.compute_dtype
    use_cfg = (guidance_scale != 1.0) if cfg_override is None else cfg_override

    def denoise(params, sd_conv, cond, x, t, fuser_scale: float, use_sd: bool,
                skip_gated: bool = False, cache=None, is_key=None):
        if sd_conv is not None and use_sd and cfg.first_conv_restorable:
            params = override_subtree(params, ("input_blocks", "0", "0"), {
                "weight": sd_conv["weight"].to(dtype),
                "bias": sd_conv["bias"].to(dtype)})
        xm = x.to(dtype)
        # the extra input channels, NCHW like x (cond holds them NHWC)
        extras = {k: None if cond.get(k) is None else nhwc_to_nchw(cond[k])
                  for k in ("grounding_extra", "inpainting_extra")}
        eg = cond.get("extra_grounding")
        if use_cfg:
            # uncond half: empty-text context and null (zero) grounding; the
            # extra input channels and the relations ride through unchanged
            # (plms.py:118-121)
            extras = {k: None if v is None else torch.cat([v, v])
                      for k, v in extras.items()}
            eg = None if eg is None else {
                k: torch.cat([v, torch.zeros_like(v)]) for k, v in eg.items()}
            x_in = torch.cat([xm, xm])
            t_in = torch.cat([t, t])
            ctx = torch.cat([cond["context"], cond["uc_context"]]).to(dtype)
            boxes = torch.cat([cond["boxes"], torch.zeros_like(cond["boxes"])])
            masks = torch.cat([cond["masks"], torch.zeros_like(cond["masks"])])
            pos = torch.cat([cond["phrase_embeddings"],
                             torch.zeros_like(cond["phrase_embeddings"])]).to(dtype)
            rel = torch.cat([cond["relations"], cond["relations"]]).to(dtype)
        else:
            x_in, t_in = xm, t
            ctx = cond["context"].to(dtype)
            boxes, masks = cond["boxes"], cond["masks"]
            pos = cond["phrase_embeddings"].to(dtype)
            rel = cond["relations"].to(dtype)
        objs = cond.get("objs")
        if objs is not None and not use_cfg and objs.shape[0] == 2 * xm.shape[0]:
            # tokens precomputed at the CFG layout ([cond; null]) for the
            # cond-only variant: keep the cond half
            objs = objs[: xm.shape[0]]

        def call_unet(enc_cache, return_cache):
            return unet_apply(params, cfg, x_in, t_in, ctx, boxes, masks, pos,
                              rel, fuser_scale=fuser_scale,
                              extra_grounding=eg, objs=objs, **extras,
                              skip_gated=skip_gated, encoder_cache=enc_cache,
                              return_encoder_cache=return_cache)

        def combine(eps):
            eps = eps.float()
            if not use_cfg:
                return eps
            e_cond, e_uncond = eps.chunk(2)
            return e_uncond + guidance_scale * (e_cond - e_uncond)

        if is_key is None:
            return combine(call_unet(None, False))
        if is_key:
            eps, new_cache = call_unet(None, True)
            return combine(eps), new_cache
        if cache is None or cache["mid_in"].shape[0] != x_in.shape[0]:
            raise RuntimeError(
                "a propagated step needs the encoder cache of a key step at "
                f"batch {x_in.shape[0]}, found "
                + ("none" if cache is None else
                   f"batch {cache['mid_in'].shape[0]}"))
        return combine(call_unet(cache, False)), cache

    return denoise


SAMPLERS = {"plms": plms_sample, "ddim": ddim_sample, "dpm": dpm_sample}


class InferencePipeline:
    """Text + layout -> image sampler: PLMS (the exact configuration), DDIM
    or DPM-Solver++(2M), with the opt-in guidance interval and encoder
    cache."""

    def __init__(self, models: GligenModels, steps: int = 50,
                 sampler: str = "plms", guidance_scale: float = 7.5,
                 alpha_type=(0.3, 0.0, 0.7), vae_chunk: Optional[int] = None,
                 eta: float = 0.0,
                 encoder_cache_interval: Optional[int] = None,
                 cfg_interval=None):
        if sampler not in SAMPLERS:
            raise ValueError(f"sampler {sampler!r}: want one of {sorted(SAMPLERS)}")
        self.models = models
        self.steps = steps
        self.sampler = sampler
        self.guidance_scale = guidance_scale
        self.alpha_type = tuple(alpha_type) if alpha_type is not None else None
        self.eta = eta
        # decode the VAE in batch chunks: the 512^2 decode is the pipeline's
        # peak-memory site
        self.vae_chunk = vae_chunk
        # encoder propagation (arXiv:2312.09608, approximate, opt-in): the
        # UNet encoder runs every Nth step, its cached features reused in
        # between; None, 0 or 1 = exact
        self.encoder_cache_interval = (
            None if not encoder_cache_interval or encoder_cache_interval <= 1
            else int(encoder_cache_interval))
        # guidance interval (arXiv:2404.07724): CFG only on the steps whose
        # fraction of the sequence lies in [lo, hi]; outside, the cond-only
        # denoiser at half the batch. None = CFG on every step
        self.cfg_interval = parse_cfg_interval(cfg_interval)
        self.tables: StepTables = make_step_tables(
            models.schedule, steps, eta=eta, alpha_type=self.alpha_type)

    # -- text encode ------------------------------------------------------

    def encode_text(self, texts: List[str]) -> torch.Tensor:
        return encode_texts_bucketed(self.models, texts)[0]

    def encode_pooled(self, texts: List[str]) -> torch.Tensor:
        """Pooled (eot) embedding per text: per-phrase grounding tokens
        (encode_one_token, modules.py:176-184) and relation triplets."""
        return encode_texts_bucketed(self.models, texts)[1]

    # -- conditioning -------------------------------------------------------

    def build_cond(self, prompts: List[str], layouts,
                   relation_texts=None) -> dict:
        """layouts: list of (boxes_ltrb, phrases) per prompt;
        relation_texts: list of relation strings per prompt (or None)."""
        m = self.models
        b = len(prompts)
        context = self.encode_text(prompts)
        uc = self.encode_text([""] * b)

        # one batched CLIP call for all phrases + relation texts of the batch
        flat_texts: List[str] = []
        spans = []
        for i, (_bxs, phrases) in enumerate(layouts):
            if len(phrases):
                spans.append(("phrase", i, len(flat_texts), len(phrases)))
                flat_texts.extend(list(phrases))
        if relation_texts is not None:
            for i, texts in enumerate(relation_texts):
                if texts:
                    texts = list(texts)[: m.max_relas]
                    spans.append(("rel", i, len(flat_texts), len(texts)))
                    flat_texts.extend(texts)
        gdim = m.unet_cfg.grounding_in_dim
        cdim = m.unet_cfg.context_dim
        flat_emb = (self.encode_pooled(flat_texts).float().cpu().numpy()
                    if flat_texts else np.zeros((0, gdim), np.float32))

        boxes = np.zeros((b, m.max_objs, 4), dtype=np.float32)
        masks = np.zeros((b, m.max_objs), dtype=np.float32)
        pos = np.zeros((b, m.max_objs, gdim), dtype=np.float32)
        rel = np.zeros((b, m.max_relas, cdim), dtype=np.float32)
        per_sample_phrase = {i: np.zeros((0, gdim), np.float32) for i in range(b)}
        for kind, i, off, n in spans:
            if kind == "phrase":
                per_sample_phrase[i] = flat_emb[off:off + n]
            else:
                rel[i, :n] = flat_emb[off:off + n]
        for i, (bxs, _phrases) in enumerate(layouts):
            boxes[i], masks[i], pos[i] = pack_layout(bxs, per_sample_phrase[i],
                                                     m.max_objs)

        dev = lambda a: torch.from_numpy(a).to(m.device)
        return {
            "context": context,
            "uc_context": uc,
            "boxes": dev(boxes),
            "masks": dev(masks),
            "phrase_embeddings": dev(pos),
            "relations": dev(rel),
        }

    # -- sampling ---------------------------------------------------------

    def _guidance_interval_on(self) -> bool:
        return self.cfg_interval is not None and self.guidance_scale != 1.0

    def _cfg_on_steps(self) -> np.ndarray:
        """(S,) bool: True where CFG applies (guidance-interval mode)."""
        lo, hi = self.cfg_interval
        s = len(self.tables.t)
        frac = np.arange(s) / max(s - 1, 1)
        return (frac >= lo) & (frac <= hi)

    def _key_steps(self) -> np.ndarray:
        """(S,) bool for encoder propagation: a key (full) forward every Nth
        step within each constant-(fuser_scale == 0, cfg_on) segment.
        Segment starts are key, so a propagated step never reads a cache
        made under another first conv, another skip_gated body or another
        batch."""
        zero = np.asarray(self.tables.fuser_scale) == 0
        cfg_on = (self._cfg_on_steps() if self._guidance_interval_on()
                  else np.ones(len(zero), dtype=bool))
        keys = np.zeros(len(zero), dtype=bool)
        seg_start = 0
        for i in range(len(zero)):
            if i and (zero[i], cfg_on[i]) != (zero[i - 1], cfg_on[i - 1]):
                seg_start = i
            keys[i] = (i - seg_start) % self.encoder_cache_interval == 0
        return keys

    @torch.no_grad()
    def run_sampler(self, cond: dict, noise,
                    generator: Optional[torch.Generator] = None,
                    blend_noise=None,
                    batch_rows: Optional[Tuple[int, slice]] = None
                    ) -> torch.Tensor:
        """Noise (B, h, w, 4) -> final latent (B, h, w, 4) f32. ``generator``
        draws DDIM's step noise where eta > 0 and, under inpainting, the
        blend's noise unless ``blend_noise`` gives it: (S, B, h, w, 4), one
        draw a step (the JAX sampler's own, in a parity test).
        ``batch_rows`` = (batch, rows): cond and noise are these rows of a
        larger batch (prompt-parallel sampling); every step's noise is
        drawn, or ``blend_noise`` given, for the whole batch and sliced."""
        m = self.models
        cond = dict(cond)
        batch, rows = batch_rows or (None, slice(None))
        inpaint = None
        if cond.get("inpaint_mask") is not None:
            to_dev = lambda a: nhwc_to_nchw(
                torch.as_tensor(a, dtype=torch.float32).to(m.device))
            step_noise = None
            if blend_noise is not None:
                blend_noise = torch.as_tensor(blend_noise, dtype=torch.float32)
                step_noise = lambda i: to_dev(blend_noise[i][rows])
            elif batch_rows is not None:
                # the blend's own draw (InpaintBlend.step_noise), whole batch
                shape = (batch,) + tuple(to_dev(cond["inpaint_z0"]).shape[1:])
                step_noise = lambda i: torch.randn(
                    shape, generator=generator, device=m.device,
                    dtype=torch.float32)[rows]
            inpaint = InpaintBlend(mask=to_dev(cond["inpaint_mask"]),
                                   z0=to_dev(cond["inpaint_z0"]),
                                   noise=step_noise, generator=generator)
        cond["objs"] = precompute_grounding_tokens(
            m, m.unet_params, cond, self.guidance_scale != 1.0)

        def bind(core, skip_gated):
            def denoise(x, t, fscale, use_sd, **kw):
                return core(m.unet_params, m.sd_first_conv, cond, x, t,
                            fscale, use_sd, skip_gated=skip_gated, **kw)
            return denoise

        core = make_cfg_denoiser(m, self.guidance_scale)
        # the skip variant is only called where fuser_scale == 0
        # (samplers._alpha_segments)
        kw = {"denoise_skip_fn": bind(core, True),
              "schedule": m.schedule, "inpaint": inpaint}
        if self._guidance_interval_on():
            nc_core = make_cfg_denoiser(m, self.guidance_scale,
                                        cfg_override=False)
            kw.update(denoise_nocfg_fn=bind(nc_core, False),
                      denoise_nocfg_skip_fn=bind(nc_core, True),
                      cfg_on=self._cfg_on_steps())
        if self.encoder_cache_interval and inpaint is None:
            kw["key_steps"] = self._key_steps()
        if self.sampler == "ddim":
            kw["generator"] = generator
            if batch_rows is not None:
                kw["noise_rows"] = batch_rows
        x0 = nhwc_to_nchw(torch.as_tensor(noise, dtype=torch.float32).to(m.device))
        z = SAMPLERS[self.sampler](bind(core, False), self.tables, x0, **kw)
        return nchw_to_nhwc(z)

    @torch.no_grad()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latent (B, h, w, 4) -> images (B, 8h, 8w, 3) f32 in [0, 1]."""
        m = self.models
        zc = nhwc_to_nchw(z.to(m.compute_dtype))
        chunk = self.vae_chunk or zc.shape[0]
        img = torch.cat([vae_decode(m.vae_params, m.vae_cfg, zc[i:i + chunk])
                         for i in range(0, zc.shape[0], chunk)])
        img = torch.clamp(img.float(), -1.0, 1.0) * 0.5 + 0.5
        return nchw_to_nhwc(img)

    def sample_latents(self, cond: dict, noise,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Conditioning + noise -> decoded images (B, 8S, 8S, 3) in [0, 1],
        as the JAX package's sample_latents returns."""
        return self.decode(self.run_sampler(cond, noise, generator))

    # -- multi-device sampling (parallel/) --------------------------------

    def sample_latents_sharded(self, mesh, cond: dict, noise,
                               generator: Optional[torch.Generator] = None
                               ) -> torch.Tensor:
        """Prompt-parallel: this rank samples and decodes its rows of the
        batch (``cond`` and ``noise`` are the whole batch's, the same on
        every rank; the weights are on every rank) and the images are
        all-gathered: every rank returns the whole (B, 8S, 8S, 3), as the
        JAX method returns the global array. DDIM's step noise at eta > 0
        is drawn for the whole batch on every rank and sliced (``generator``
        advances alike on every rank)."""
        b = noise.shape[0]
        rows = row_block(b, mesh)
        z = self.run_sampler(shard_batch(mesh, cond), noise[rows], generator,
                             batch_rows=(b, rows))
        return all_gather(mesh, self.decode(z), dim=0)

    def sample_latents_tp(self, mesh, cond: dict, noise,
                          generator: Optional[torch.Generator] = None,
                          style: str = "spatial") -> torch.Tensor:
        """Tensor-parallel latency mode (parallel/tp.py): every rank holds
        the whole batch and the weights, and each image's compute is split
        over the ranks: 'spatial' (default) splits image rows everywhere,
        the convolutions included; 'heads' splits attention heads and the
        FF's inner dimension, the convolutions whole. For the wait of one
        request, not for throughput: generate_sharded needs no collective
        until the images are gathered. Every rank returns the images."""
        with tp_mode(mesh, style):
            return self.sample_latents(cond, noise, generator)

    def generate_sharded(self, mesh, prompts: List[str], layouts,
                         relation_texts=None, seed: int = 42,
                         seeds: Optional[Sequence[int]] = None) -> np.ndarray:
        """generate's images, the batch's rows split over the mesh (the
        reference's num_per_prompt / data-parallel axis). The conditioning
        is built for the whole batch (so the text encoder runs the batch
        shape of one device) and broadcast from rank 0, so ranks agree
        whatever their tokenizers' hashing; every rank draws the whole
        batch's noise and takes its rows."""
        row_block(len(prompts), mesh)
        cond = replicate(mesh, self.build_cond(prompts, layouts, relation_texts))
        noise, gen = self._batch_noise(len(prompts), seed, seeds)
        return self.sample_latents_sharded(mesh, cond, noise, gen).cpu().numpy()

    def generate_tp(self, mesh, prompts: List[str], layouts,
                    relation_texts=None, seed: int = 42,
                    seeds: Optional[Sequence[int]] = None,
                    style: str = "spatial") -> np.ndarray:
        """Latency-mode generate: a (small) batch, each image's compute
        split over the mesh (sample_latents_tp); conditioning and noise as
        generate_sharded's."""
        cond = replicate(mesh, self.build_cond(prompts, layouts, relation_texts))
        noise, gen = self._batch_noise(len(prompts), seed, seeds)
        return self.sample_latents_tp(mesh, cond, noise, gen,
                                      style=style).cpu().numpy()

    def _batch_noise(self, b: int, seed: int,
                     seeds: Optional[Sequence[int]] = None):
        """(noise (b, h, w, c) f32, the generator that goes on to draw any
        step noise). With per-row ``seeds`` each row's noise comes from a
        generator seeded with that row's seed alone, so a request gives the
        same image whatever batch it is served in (serving/batcher.py; for
        the deterministic samplers: DDIM with eta > 0 draws its step noise
        batch-wide). Default: one batch draw from ``seed``."""
        m = self.models
        size = m.unet_cfg.image_size
        shape = (size, size, m.unet_cfg.in_channels)

        def drawn(s, rows):
            gen = torch.Generator(device=m.device)
            gen.manual_seed(int(s))
            return gen, torch.randn(rows + shape, generator=gen,
                                    device=m.device, dtype=torch.float32)

        if seeds is None:
            gen, noise = drawn(seed, (b,))
            return noise, gen
        if len(seeds) != b:
            raise ValueError(f"seeds: want {b} entries, got {len(seeds)}")
        gens, rows = zip(*(drawn(s, ()) for s in seeds))
        return torch.stack(rows), gens[0]

    def generate(self, prompts: List[str], layouts, relation_texts=None,
                 seed: int = 42,
                 seeds: Optional[Sequence[int]] = None) -> np.ndarray:
        """Returns (B, 8S, 8S, 3) float images in [0, 1] (S the UNet
        config's image_size). ``seeds``: see
        _batch_noise (per-request reproducibility for serving batches)."""
        cond = self.build_cond(prompts, layouts, relation_texts)
        noise, gen = self._batch_noise(len(prompts), seed, seeds)
        return self.sample_latents(cond, noise, gen).cpu().numpy()


def images_to_uint8(images: np.ndarray) -> np.ndarray:
    return (np.clip(images, 0, 1) * 255).astype(np.uint8)
