"""Model of the port: embeddings + stack + chunked-loss head
(``repro.models.model`` in the reference).  Public API:

    model = Model(cfg)
    params = model.init(generator)                 (device=None: the card)
    loss, aux = model.loss(params, batch)
    logits, cache = model.prefill(params, batch)
    logits, cache = model.decode_step(params, cache, tokens, pos)

Batch dict keys:
    tokens (b, s) int            — or inputs_embeds (b, s, d) for [vlm]
    labels (b, s) int            — train only
    positions (b, s) int         — or (3, b, s) for M-RoPE
    enc_embeds (b, enc_seq, d)   — encoder-decoder only (stub frontend output)

Parameter trees have the reference's structure, leaf names and dtypes, so
`core.placement` serializes the port's tree to the reference's bytes and
either package reads parameters the other stored.

Parameters laid out over a (data, model) mesh (``sharding.place.place``
by ``sharding.policy.param_specs``) run through the same methods:
``sharding.parallel`` splits the batch and the vocab over the mesh and
every block's compute as the policy splits its leaves
(``sharding.blocks``); hidden states, logits and caches then come back
``Sharded``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.placement import tree_flatten
from repro_torch.device import resolve_device
from repro_torch.sharding import parallel, policy
from repro_torch.sharding.place import Sharded, place

from . import transformer as tfm
from .layers import (COMPUTE_DTYPE, apply_norm, embed_init, init_norm,
                     positions_to_angles)

Params = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Model:
    def __init__(self, cfg):
        self.cfg = cfg

    # ------------------------------------------------------------- params
    def init(self, gen, device=None) -> Params:
        """Parameters drawn from ``gen`` (a ``torch.Generator`` on
        ``device``, or a numpy ``Generator``), as tensors on ``device``
        (None: the card)."""
        cfg = self.cfg
        device = resolve_device(device)
        params: dict = {
            "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), device),
            "final_norm": init_norm(cfg, cfg.d_model, device),
            "stack": tfm.init_stack(cfg, gen, decoder=cfg.is_encoder_decoder,
                                    device=device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = embed_init(gen, (cfg.d_model, cfg.vocab_size),
                                           device)
        if cfg.is_encoder_decoder:
            enc_cfg = self._encoder_cfg()
            params["encoder"] = {
                "stack": tfm.init_stack(enc_cfg, gen, device=device),
                "final_norm": init_norm(enc_cfg, enc_cfg.d_model, device),
            }
        if cfg.param_dtype != "float32":
            dt = _DTYPES[cfg.param_dtype]
            leaves, treedef = tree_flatten(params)
            params = treedef.unflatten([x.to(dt) for x in leaves])
        return params

    def _encoder_cfg(self):
        cfg = self.cfg
        return dataclasses.replace(
            cfg, n_layers=cfg.encoder_layers, layer_pattern=("enc",),
            is_encoder_decoder=False)

    def head(self, params):
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["lm_head"]

    def _logits(self, params, h) -> torch.Tensor:
        """bf16 ``h @ head``, then fp32."""
        return (h @ self.head(params).to(h.dtype)).float()

    # -------------------------------------------------------------- embed
    def _embed_inputs(self, params, batch) -> torch.Tensor:
        if "inputs_embeds" in batch:
            return batch["inputs_embeds"].to(COMPUTE_DTYPE)
        # gather, then cast: the same values as the reference's cast of
        # the whole table before the gather, without a bf16 copy of it
        return params["embed"][batch["tokens"]].to(COMPUTE_DTYPE)

    def _encode(self, params, batch, run=None) -> Optional[torch.Tensor]:
        """The encoder over ``batch["enc_embeds"]``: bidirectional "enc"
        blocks in train mode (no cache, no remat), positions 0..s-1, then
        the encoder's final norm."""
        if not self.cfg.is_encoder_decoder:
            return None
        enc_cfg = self._encoder_cfg()
        x = batch["enc_embeds"].to(COMPUTE_DTYPE)
        if run is not None and not isinstance(x, Sharded):
            x = run.act(run.each(lambda i: run.local(x, i)))
        b, s, _ = x.shape
        pos = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(
            b, s)
        cos, sin = positions_to_angles(enc_cfg, pos)
        ctx = tfm.Ctx(mode="train", cos=cos, sin=sin, q_pos=pos, pos=None,
                      max_len=s, run=run)
        x, _, _ = tfm.apply_stack(enc_cfg, params["encoder"]["stack"], x, ctx,
                                  None, remat=False)
        return self._norm(enc_cfg, params["encoder"]["final_norm"], x, run)

    @staticmethod
    def _norm(cfg, p, x, run):
        if run is None:
            return apply_norm(cfg, p, x)
        return parallel.per_group(run, lambda xi, pi: apply_norm(cfg, pi, xi),
                                  x, p)

    # ------------------------------------------------------------ forward
    def _positions(self, batch) -> torch.Tensor:
        if "positions" in batch:
            return batch["positions"]
        if "inputs_embeds" in batch:
            b, s, _ = batch["inputs_embeds"].shape
            dev = batch["inputs_embeds"].device
        else:
            b, s = batch["tokens"].shape
            dev = batch["tokens"].device
        return torch.arange(s, dtype=torch.int32, device=dev)[None].expand(
            b, s)

    def forward(self, params, batch, mode: str, cache=None, *,
                pos: Optional[int] = None, max_len: int = 0,
                q_chunk: Optional[int] = None, remat: bool = True):
        """Returns (final-normed hidden states, new cache or None, aux).
        ``remat`` recomputes each cycle's activations in the backward
        (mode "train" only)."""
        cfg = self.cfg
        run = parallel.run_for(params, batch)
        x = (self._embed_inputs(params, batch) if run is None
             else parallel.embed(run, params, batch, COMPUTE_DTYPE))
        positions = self._positions(batch)
        if isinstance(positions, Sharded):
            positions = positions.gather()
        # masks use the temporal stream when M-RoPE supplies (t, h, w) streams
        rope_pos = positions[0] if positions.ndim == 3 else positions   # (b,s)
        cos, sin = positions_to_angles(cfg, positions)
        enc_out = (self._encode(params, batch, run)
                   if cfg.is_encoder_decoder and mode != "decode" else None)
        ctx = tfm.Ctx(mode=mode, cos=cos, sin=sin, q_pos=rope_pos,
                      pos=None if pos is None else int(pos), max_len=max_len,
                      enc_out=enc_out, q_chunk=q_chunk, run=run)
        x, cache, aux = tfm.apply_stack(cfg, params["stack"], x, ctx, cache,
                                        decoder=cfg.is_encoder_decoder,
                                        remat=remat)
        x = self._norm(cfg, params["final_norm"], x, run)
        return x, cache, aux

    # --------------------------------------------------------------- loss
    def loss(self, params, batch, *, remat: bool = True):
        """Mean next-token cross entropy, chunked over the sequence by
        ``cfg.loss_chunk``: each chunk's logits are a bf16 ``h @ head``
        taken to fp32 (softcapped when ``cfg.logit_softcap``), and its
        ``logsumexp - logit[label]`` summed in order.  Returns
        ``(xent + 0.01 * aux, {"xent", "aux"})``.  Sharded parameters:
        ``sharding.parallel.loss``."""
        if parallel.run_for(params, batch) is not None:
            return parallel.loss(self, params, batch, remat=remat)
        cfg = self.cfg
        h, _, aux = self.forward(params, batch, "train", remat=remat)
        labels = batch["labels"].long()
        head = self.head(params).to(COMPUTE_DTYPE)
        b, s, _ = h.shape
        chunk = min(cfg.loss_chunk, s)
        if s % chunk:
            chunk = s
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for c in range(0, s, chunk):
            logits = (h[:, c:c + chunk] @ head).float()
            if cfg.logit_softcap:
                logits = cfg.logit_softcap * torch.tanh(
                    logits / cfg.logit_softcap)
            lse = torch.logsumexp(logits, dim=-1)
            ll = torch.take_along_dim(
                logits, labels[:, c:c + chunk, None], dim=-1)[..., 0]
            total = total + (lse - ll).sum()
        loss = total / (b * s)
        return loss + 0.01 * aux, {"xent": loss, "aux": aux}

    # ------------------------------------------------------------ serving
    def init_cache(self, batch: int, max_len: int, device=None):
        return tfm.init_stack_cache(self.cfg, batch, max_len,
                                    decoder=self.cfg.is_encoder_decoder,
                                    device=resolve_device(device))

    @torch.inference_mode()
    def prefill(self, params, batch, *, max_len: int = 0,
                q_chunk: Optional[int] = 1024):
        """Run the prompt, return (last-position logits, filled cache)."""
        if "inputs_embeds" in batch:
            b, s = batch["inputs_embeds"].shape[:2]
        else:
            b, s = batch["tokens"].shape
        max_len = max(max_len, s)
        cache = self.init_cache(b, max_len, params["embed"].device)
        run = parallel.run_for(params, batch)
        if run is not None:     # the cache laid out as the policy says
            cache = place(cache, policy.named(
                policy.cache_spec(cache, run.mesh, batch=b), run.mesh))
        h, cache, _ = self.forward(params, batch, "prefill", cache,
                                   max_len=max_len, q_chunk=q_chunk)
        if run is not None:
            return parallel.logits(run, self, params, h, last=True), cache
        return self._logits(params, h[:, -1:]), cache

    @torch.inference_mode()
    def decode_step(self, params, cache, tokens, pos, *, max_len: int):
        """tokens: (b, 1) int; pos: absolute position of the incoming
        token.  Returns (logits (b,1,V), new cache)."""
        b = tokens.shape[0]
        positions = torch.full((b, 1), int(pos), dtype=torch.int32,
                               device=tokens.device)
        batch = {"tokens": tokens, "positions": positions}
        h, cache, _ = self.forward(params, batch, "decode", cache, pos=pos,
                                   max_len=max_len)
        run = parallel.run_for(params, batch)
        if run is not None:
            return parallel.logits(run, self, params, h), cache
        return self._logits(params, h), cache
