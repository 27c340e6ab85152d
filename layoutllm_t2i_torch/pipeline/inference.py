"""Layout-grounded generation pipeline (layoutllm_t2i_tpu/pipeline/
inference.py; reference GLIGEN interface.py).

CLIP text encode -> PositionNet grounding tokens (once, outside the step
loop) -> PLMS over a doubled-batch CFG denoiser -> VAE decode. Host code
builds fixed-shape (max_objs=30, max_relas) tensors from the ragged layout,
mirroring interface.py:157-290. Public tensors keep the JAX package's
shapes: noise (B, 64, 64, 4), images (B, 512, 512, 3) in [0, 1].
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, default_dtype, resolve_device
from ..diffusion.samplers import StepTables, make_step_tables, plms_sample
from ..models.clip_text import CLIPTextConfig, clip_text_apply
from ..models.position_net import position_net
from ..models.unet import UNetConfig, unet_apply
from ..models.vae import VAEConfig, decode as vae_decode
from ..ops.nn import nchw_to_nhwc, nhwc_to_nchw
from ..ops.schedules import DDPMSchedule
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
    the (2B or B, N, C) tokens in make_cfg_denoiser's batch layout."""
    pn = unet_params["position_net"]
    objs_c = position_net(pn, cond["boxes"], cond["masks"],
                          cond["phrase_embeddings"])
    if not use_cfg:
        return objs_c
    objs_u = position_net(pn, torch.zeros_like(cond["boxes"]),
                          torch.zeros_like(cond["masks"]),
                          torch.zeros_like(cond["phrase_embeddings"]))
    return torch.cat([objs_c, objs_u])


def make_cfg_denoiser(models: GligenModels, guidance_scale: float):
    """Returns denoise(params, sd_conv, cond, x, t, fuser_scale, use_sd,
    skip_gated=False) with classifier-free guidance as one doubled batch
    (the reference issues two UNet calls, plms.py:115-124). x is the
    (B, 4, h, w) channels_last f32 latent; the result is f32 eps."""
    cfg = models.unet_cfg
    dtype = models.compute_dtype
    use_cfg = guidance_scale != 1.0

    def denoise(params, sd_conv, cond, x, t, fuser_scale: float, use_sd: bool,
                skip_gated: bool = False):
        if sd_conv is not None and use_sd:
            params = override_subtree(params, ("input_blocks", "0", "0"), {
                "weight": sd_conv["weight"].to(dtype),
                "bias": sd_conv["bias"].to(dtype)})
        xm = x.to(dtype)
        if use_cfg:
            # uncond half: empty-text context and null (zero) grounding; the
            # relations ride through unchanged (plms.py:118-121)
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
        eps = unet_apply(params, cfg, x_in, t_in, ctx, boxes, masks, pos, rel,
                         fuser_scale=fuser_scale, objs=cond.get("objs"),
                         skip_gated=skip_gated).float()
        if not use_cfg:
            return eps
        e_cond, e_uncond = eps.chunk(2)
        return e_uncond + guidance_scale * (e_cond - e_uncond)

    return denoise


class InferencePipeline:
    """Text + layout -> image sampler (exact configuration: PLMS)."""

    def __init__(self, models: GligenModels, steps: int = 50,
                 sampler: str = "plms", guidance_scale: float = 7.5,
                 alpha_type=(0.3, 0.0, 0.7), vae_chunk: Optional[int] = None):
        if sampler != "plms":
            raise NotImplementedError(
                f"sampler {sampler!r}: only 'plms' is ported so far")
        self.models = models
        self.steps = steps
        self.sampler = sampler
        self.guidance_scale = guidance_scale
        self.alpha_type = tuple(alpha_type) if alpha_type is not None else None
        # decode the VAE in batch chunks: the 512^2 decode is the pipeline's
        # peak-memory site
        self.vae_chunk = vae_chunk
        self.tables: StepTables = make_step_tables(
            models.schedule, steps, alpha_type=self.alpha_type)

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

    @torch.no_grad()
    def run_sampler(self, cond: dict, noise) -> torch.Tensor:
        """Noise (B, h, w, 4) -> final latent (B, h, w, 4) f32."""
        m = self.models
        denoise_core = make_cfg_denoiser(m, self.guidance_scale)
        cond = dict(cond)
        cond["objs"] = precompute_grounding_tokens(
            m, m.unet_params, cond, self.guidance_scale != 1.0)

        def denoise(x, t, fscale, use_sd):
            return denoise_core(m.unet_params, m.sd_first_conv, cond, x, t,
                                fscale, use_sd)

        def denoise_skip(x, t, fscale, use_sd):
            # only called where fuser_scale == 0 (see _alpha_segments)
            return denoise_core(m.unet_params, m.sd_first_conv, cond, x, t,
                                fscale, use_sd, skip_gated=True)

        x0 = nhwc_to_nchw(torch.as_tensor(noise, dtype=torch.float32).to(m.device))
        z = plms_sample(denoise, self.tables, x0, denoise_skip_fn=denoise_skip)
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

    def sample_latents(self, cond: dict, noise) -> torch.Tensor:
        """Conditioning + noise -> decoded images (B, 512, 512, 3) in [0, 1],
        as the JAX package's sample_latents returns."""
        return self.decode(self.run_sampler(cond, noise))

    def _batch_noise(self, b: int, seed: int) -> torch.Tensor:
        m = self.models
        gen = torch.Generator(device=m.device)
        gen.manual_seed(seed)
        size = m.unet_cfg.image_size
        return torch.randn((b, size, size, m.unet_cfg.in_channels),
                           generator=gen, device=m.device, dtype=torch.float32)

    def generate(self, prompts: List[str], layouts, relation_texts=None,
                 seed: int = 42) -> np.ndarray:
        """Returns (B, 512, 512, 3) float images in [0, 1]."""
        cond = self.build_cond(prompts, layouts, relation_texts)
        img = self.sample_latents(cond, self._batch_noise(len(prompts), seed))
        return img.cpu().numpy()


def images_to_uint8(images: np.ndarray) -> np.ndarray:
    return (np.clip(images, 0, 1) * 255).astype(np.uint8)
