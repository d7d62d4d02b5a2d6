"""Modality frontend STUBS of the port (``repro.models.frontend`` in the
reference): the [audio] and [vlm] configs specify the transformer
BACKBONE only; the model consumes precomputed frame or patch embeddings.

These helpers give the stand-in embedding shapes, a seeded synthetic
generator for smoke runs, and the Qwen2-VL M-RoPE position streams.  A
real deployment would replace them with the conv feature extractor
(whisper) or the dynamic-resolution ViT (qwen2-vl).
"""
from __future__ import annotations

import numpy as np
import torch


def audio_frame_embeddings_shape(cfg, batch: int) -> tuple[int, int, int]:
    """Whisper: 30 s of audio -> cfg.encoder_seq log-mel frame embeddings."""
    return (batch, cfg.encoder_seq, cfg.d_model)


def vision_patch_embeddings_shape(cfg, batch: int,
                                  seq: int) -> tuple[int, int, int]:
    """Qwen2-VL: dynamic-resolution patches + text, already merged to one
    stream of `seq` embeddings."""
    return (batch, seq, cfg.d_model)


def synth_embeddings(gen, shape, dtype=torch.bfloat16,
                     device=None) -> torch.Tensor:
    """Standard normal draws * 0.02 of ``shape``, cast to ``dtype``, from
    ``gen`` (a ``torch.Generator`` on ``device`` or a numpy
    ``Generator``).  The draws are not ``jax.random``'s; feed both
    packages one array to compare them."""
    if isinstance(gen, np.random.Generator):
        x = torch.from_numpy(gen.standard_normal(shape, dtype=np.float32))
        x = x.to(device)
    else:
        x = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
    # the scale in ``dtype``, as the reference's weakly typed 0.02
    return x.to(dtype) * torch.tensor(0.02, dtype=dtype, device=x.device)


def mrope_positions(batch: int, seq: int, *, image_tokens: int = 0,
                    grid_hw: tuple[int, int] = (0, 0)) -> np.ndarray:
    """Qwen2-VL M-RoPE position streams (3, b, s): vision tokens get
    (t, h, w) grid coordinates, text tokens advance all three streams
    together."""
    t = np.zeros((3, seq), dtype=np.int32)
    if image_tokens:
        gh, gw = grid_hw
        if gh * gw != image_tokens:
            raise ValueError(f"grid {grid_hw} does not hold {image_tokens} "
                             f"image tokens")
        hh, ww = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
        t[0, :image_tokens] = 0
        t[1, :image_tokens] = hh.reshape(-1)
        t[2, :image_tokens] = ww.reshape(-1)
        base = max(gh, gw)
    else:
        base = 0
    text = np.arange(seq - image_tokens, dtype=np.int32) + base
    t[:, image_tokens:] = text[None]
    return np.broadcast_to(t[:, None, :], (3, batch, seq)).copy()
