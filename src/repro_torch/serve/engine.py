"""Serving layer of the port: coded storage reads + batched LLM inference
(``repro.serve.engine`` in the reference).

Two engines live here, layered:

* :class:`CodedReadServer` — degraded-read block serving over the cluster
  simulator.  Every read goes to the block's assigned node when it is up
  (systematic: raw bytes, zero field operations) and *transparently* falls
  back to a one-launch any-k decode through the fused repair engine's
  cached inverses when assigned nodes are down, slow, or lost.  The node
  state, latency model and byte accounting come from
  `repro_torch.cluster.ClusterSimulator`, so a serving workload and a
  failure scenario compose directly.

* :class:`ServingEngine` — prefill + KV-cache decode with a simple
  continuous-batching request queue (admit-on-slot-free), on the device
  of its parameters.  Its parameters can be materialized straight out of
  a :class:`CodedReadServer` or a coded object store
  (:meth:`ServingEngine.from_coded_store`): the kill-nodes-while-serving
  path of ``examples/serve_demo.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import placement
from repro_torch.exec.plan import PlanStats
from repro_torch.models import Model


class CodedReadServer:
    """Degraded-read serving facade over a cluster simulator.

    Parameters
    ----------
    sim : repro_torch.cluster.ClusterSimulator
        Owns node state, the encoded blocks, the latency model and the
        metrics log.  Reads issued here and scenario events run through
        ``sim.run`` share one accounting stream.
    treedef, tspec : optional
        When the stored object is a tree (`placement.pytree_to_blocks`),
        these let :meth:`read_state` rebuild it.

    Notes
    -----
    The degraded path is exactly the paper's any-k data-collector decode,
    but served one *row* at a time: block a_j is ``inv[j] @ downloads``
    with the (n, n) inverse LRU-cached per node subset, so an outage's
    worth of degraded reads costs one `gf.gauss_inverse` total.  Every
    degraded decode goes through the execution-plan layer, so a serving
    fleet reading objects of mixed sizes compiles nothing new at steady
    state — :meth:`plan_stats` is the live counter.
    """

    def __init__(self, sim, treedef=None, tspec=None):
        self.sim = sim
        self.treedef = treedef
        self.tspec = tspec
        self._clock = 0.0

    def plan_stats(self) -> PlanStats:
        """Hits/misses/compiles of the code's execution-plan cache —
        steady-state serving must show a frozen ``compiles`` count."""
        planner = self.sim.code.planner
        if planner is None:
            return PlanStats(0, 0, 0)
        return planner.plan_stats()

    @classmethod
    def for_pytree(cls, state: Any, spec, **sim_kwargs) -> "CodedReadServer":
        """Encode a tree across the cluster and serve reads of it.

        Serializes ``state`` into the code's n data blocks
        (`placement.pytree_to_blocks`), builds a fresh `ClusterSimulator`
        holding the encoded blocks (``device=`` among ``sim_kwargs``; None
        is the card), and returns the server wired for
        :meth:`read_state`.
        """
        from repro_torch.cluster.simulator import ClusterSimulator
        blocks, treedef, tspec = placement.pytree_to_blocks(
            state, spec.n, spec.p)
        sim = ClusterSimulator(spec, blocks, **sim_kwargs)
        return cls(sim, treedef=treedef, tspec=tspec)

    def _tick(self) -> float:
        self._clock += 1.0
        return self._clock

    def read_block(self, block: int) -> Optional[np.ndarray]:
        """One data block, systematic or transparently degraded;
        None only when fewer than k nodes are up."""
        return self.sim.read_block(block, self._tick())

    def read_blocks(self) -> Optional[np.ndarray]:
        """The full (n, S) data matrix — systematic rows where owners are
        up, ONE decode launch for everything else."""
        return self.sim.read_all(self._tick())

    def read_state(self) -> Any:
        """Rebuild the stored tree (requires ``for_pytree``), its leaves
        tensors on the simulator's device, whatever the current node
        state — raises only below k survivors."""
        if self.treedef is None or self.tspec is None:
            raise RuntimeError("server was not built with for_pytree()")
        blocks = self.read_blocks()
        if blocks is None:
            raise RuntimeError(
                f"unrecoverable: fewer than k={self.sim.k} nodes up")
        return placement.blocks_to_pytree(blocks, self.treedef, self.tspec,
                                          self.sim.device)

    @property
    def metrics(self):
        return self.sim.metrics


def _read_coded_params(store, key: Optional[str]):
    """One param-materialization path for both storage layers: a coded
    object store (``key`` names the tree object) or a CodedReadServer
    (``key=None``, the single-stripe cluster read)."""
    if key is not None:
        return store.get_pytree(key)
    return store.read_state()


# ------------------------------------------------------------- LLM serving
@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (s,) int32
    max_new_tokens: int
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServingEngine:
    """Batched prefill/decode engine with continuous batching.

    Parameters
    ----------
    model : Model
        The architecture to serve.
    params : tree of tensors
        Model parameters (materialize them from coded storage with
        :meth:`from_coded_store`); the engine computes on their device.
    batch_size : int
        Concurrent decode slots.
    max_len : int
        KV-cache capacity; prompts + new tokens must fit.
    temperature : float
        0 = greedy argmax (the first maximum, as ``jnp.argmax``);
        otherwise categorical sampling from a ``torch.Generator`` seeded
        with ``seed`` (not the reference's ``jax.random`` draws).

    The reference jits its prefill and decode step; here they are eager
    calls under ``torch.inference_mode``.
    """

    def __init__(self, model: Model, params, *, batch_size: int, max_len: int,
                 temperature: float = 0.0, seed: int = 0):
        self.model = model
        self.params = params
        self.batch_size = batch_size
        self.max_len = max_len
        self.temperature = temperature
        self.seed = seed
        self._gen: Optional[torch.Generator] = None

    @classmethod
    def from_coded_store(cls, model: Model, store, *, key: Optional[str] = None,
                         **engine_kwargs) -> "ServingEngine":
        """Materialize parameters out of MSR-coded storage and serve.

        ``store`` is either a :class:`CodedReadServer` (single-stripe
        cluster; ``key`` omitted) or a `repro_torch.store.CodedObjectStore`
        holding the parameters as a tree object under ``key``
        (``put_pytree``).  Either way the read is systematic when the
        storage is healthy and falls back to the one-launch degraded
        decode for whatever is missing — the engine itself cannot tell
        the difference (bit-exact either way).  The parameters land on
        the storage's device."""
        return cls(model, _read_coded_params(store, key), **engine_kwargs)

    def reload_params(self, store, *, key: Optional[str] = None) -> None:
        """Re-read parameters from coded storage (e.g. after the cluster
        repaired a failed node, or to pick up a new checkpoint).  Accepts
        the same ``store``/``key`` pairs as :meth:`from_coded_store`."""
        self.params = _read_coded_params(store, key)

    # ----------------------------------------------------------- one batch
    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, max_new_tokens: int,
                 stop_token: Optional[int] = None) -> np.ndarray:
        """prompts: (b, s) int32, same length (padded upstream).
        Returns (b, max_new_tokens) int32."""
        b, s = prompts.shape
        if s + max_new_tokens > self.max_len:
            raise ValueError(f"prompt {s} + {max_new_tokens} new tokens "
                             f"exceeds cache capacity {self.max_len}")
        tokens = torch.as_tensor(np.asarray(prompts, np.int32),
                                 device=self.params["embed"].device)
        logits, cache = self.model.prefill(self.params, {"tokens": tokens},
                                           max_len=self.max_len,
                                           q_chunk=None)
        out = np.zeros((b, max_new_tokens), np.int32)
        tok = self._sample(logits)
        for t in range(max_new_tokens):
            out[:, t] = tok[:, 0].cpu().numpy()
            logits, cache = self.model.decode_step(self.params, cache, tok,
                                                   s + t,
                                                   max_len=self.max_len)
            tok = self._sample(logits)
        return out

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        logits = logits[:, -1, :]
        if self.temperature <= 0.0:
            return torch.argmax(logits, -1)[:, None].to(torch.int32)
        if self._gen is None or self._gen.device != logits.device:
            self._gen = torch.Generator(device=logits.device).manual_seed(
                self.seed)
        probs = torch.softmax(logits / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen).to(
            torch.int32)

    # ------------------------------------------------- continuous batching
    def serve(self, requests: list[Request], prompt_len: int) -> list[Request]:
        """Round-based continuous batching: up to `batch_size` active slots;
        a finished request's slot is refilled from the queue at the next
        prefill round.  Prompts are right-aligned/padded to prompt_len."""
        queue = list(requests)
        done: list[Request] = []
        while queue:
            active = queue[: self.batch_size]
            queue = queue[self.batch_size:]
            prompts = np.zeros((len(active), prompt_len), np.int32)
            for i, r in enumerate(active):
                p = r.prompt[-prompt_len:]
                prompts[i, prompt_len - len(p):] = p
            steps = max(r.max_new_tokens for r in active)
            outs = self.generate(prompts, steps)
            for i, r in enumerate(active):
                r.out_tokens = outs[i, : r.max_new_tokens].tolist()
                r.done = True
                done.append(r)
        return done


__all__ = ["CodedReadServer", "Request", "ServingEngine"]
