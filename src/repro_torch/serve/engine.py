"""Batched serving engine: slot-based continuous batching.

The port of ``repro/serve/engine.py``, for the models of the ``tokens``
input mode (the others raise: their prompts carry embeddings, and they
are served through ``lm.prefill_step`` and ``lm.decode_step``).
Requests are prefilled one at a time (prompt lengths vary), each
prompt's caches are copied into a fixed batch *slot*, and one decode
step advances every slot with a position per slot; a finished slot frees
at once and is refilled from the queue while the others go on
(continuous batching).

Where the reference ``vmap``s a B=1 decode over the slots, the port writes
the batch dimension out: the stacked caches are ``(L, slots, S_c, KV,
hd)`` (an MLA layer's latent cache ``(L, slots, S_c, kv_lora_rank)`` and
``(L, slots, S_c, qk_rope_dim)``, a recurrent layer's state ``(L, slots,
...)``) and ``lm.decode_step`` takes a position vector ``(slots,)``, each
row writing its cache entry at its own position and masking ``idx <=
pos[b]``.  Free slots are decoded too, at the position they last held, as
in the reference; their writes are clamped into the cache
(``models/attention.py:decode_attention``, ``models/mla.py:mla_decode``),
so a slot retired at ``cache_len - 1`` never writes out of range.  Greedy sampling is
``argmax`` (first index on ties, as ``jnp.argmax``); temperature sampling
draws with ``torch.multinomial`` from the engine's own generator.

``Engine.stats`` keeps the serving metrics on the host clock: each
prefill's seconds beside its prompt length, and the decode steps, their
seconds and the tokens they produced.  Sampling copies the tokens to the
host, so each interval ends after the device has finished its work.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._tree import leaves
from repro_torch.models import lm
from repro_torch.models import transformer as tfm


@dataclasses.dataclass
class ServeConfig:
    max_slots: int = 4
    cache_len: int = 512
    max_new_tokens: int = 64
    eos_id: int = -1  # -1: never stops early
    greedy: bool = True
    temperature: float = 1.0


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class EngineStats:
    #: (prompt tokens, seconds) per prefill, its sampling included
    prefill: List[Tuple[int, float]] = dataclasses.field(default_factory=list)
    decode_steps: int = 0
    decode_s: float = 0.0
    #: tokens the decode steps produced for active slots
    decode_tokens: int = 0


def check_input_mode(cfg) -> None:
    """Raise ``ValueError`` naming the input mode unless ``cfg`` takes
    token prompts: the engine's prefill builds ``{"tokens": ...}``, as the
    reference's does."""
    if cfg.input_mode != "tokens":
        raise ValueError(
            f"{cfg.name} takes input mode {cfg.input_mode!r}: the engine "
            f"serves token prompts; call lm.prefill_step and "
            f"lm.decode_step with the batch's embeds")


class Engine:
    def __init__(self, cfg, params, serve_cfg: ServeConfig, device="cuda"):
        check_input_mode(cfg)
        self.cfg = cfg
        self.params = params
        self.scfg = serve_cfg
        self.device = torch.device(device)
        self.queue: List[Request] = []
        self.done: Dict[int, Request] = {}
        self._next_rid = 0
        self._slots: List[Optional[Request]] = [None] * serve_cfg.max_slots
        self._caches = None  # stacked caches, batch = max_slots
        self._pos = np.zeros(serve_cfg.max_slots, dtype=np.int64)
        self._last_tok = np.zeros(serve_cfg.max_slots, dtype=np.int64)
        # seed 0, as the reference engine's PRNGKey(0)
        self._gen = torch.Generator(device=self.device).manual_seed(0)
        self.stats = EngineStats()

    # -- public -----------------------------------------------------------------
    def submit(self, prompt) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, np.asarray(prompt, dtype=np.int32)))
        return rid

    @torch.inference_mode()
    def run(self) -> Dict[int, List[int]]:
        """Run until every submitted request completes."""
        while self.queue or any(s is not None for s in self._slots):
            self.step()
        return {rid: r.generated for rid, r in sorted(self.done.items())}

    # -- internals ----------------------------------------------------------------
    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s is None]

    def _admit(self):
        for slot in self._free_slots():
            if not self.queue:
                break
            req = self.queue.pop(0)
            t0 = time.perf_counter()
            tokens = torch.as_tensor(req.prompt, dtype=torch.int64,
                                     device=self.device)[None, :]
            logits, caches = lm.prefill_step(self.cfg, self.params,
                                             {"tokens": tokens},
                                             self.scfg.cache_len)
            tok = int(self._sample(logits)[0])
            self.stats.prefill.append((len(req.prompt),
                                       time.perf_counter() - t0))
            req.generated.append(tok)
            self._place(slot, req, caches, len(req.prompt), tok)

    def _place(self, slot: int, req: Request, caches, pos: int, tok: int):
        """Copy one request's prefill caches (batch 1) into batch slot
        ``slot`` of the engine's.  Generic over every decode state the
        stack keeps, as the reference stacks them with ``jax.tree.map``:
        attention KV caches (full or rolling), MLA's ``MLACache(c_kv,
        k_rope)``, ``RGLRUState(h, conv_tail)``,
        ``MLSTMState(C, n, m)`` and ``SLSTMState(h, c, n, m)``; each leaf
        has the batch first, or second behind the layer dim of a stacked
        segment, and is copied into the slot's leaf in that leaf's type."""
        if self._caches is None:
            self._caches = lm.init_caches(self.cfg, self.scfg.max_slots,
                                          self.scfg.cache_len,
                                          device=self.device)
        for (kind, n, _), full, one in zip(tfm.stack_templates(self.cfg),
                                           self._caches, caches):
            for f, o in zip(leaves(full), leaves(one)):
                dst, src = (f[:, slot], o[:, 0]) if n > 1 else (f[slot], o[0])
                if dst.shape != src.shape:
                    raise ValueError(f"{kind} cache leaf {tuple(src.shape)} "
                                     f"does not fit the slot's "
                                     f"{tuple(dst.shape)}")
                dst.copy_(src)
        self._slots[slot] = req
        self._pos[slot] = pos
        self._last_tok[slot] = tok

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        if self.scfg.greedy:
            return torch.argmax(logits, dim=-1).cpu().numpy()
        probs = torch.softmax(logits.float() / self.scfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0].cpu(
        ).numpy()

    def _retire(self, slot: int):
        req = self._slots[slot]
        req.done = True
        self.done[req.rid] = req
        self._slots[slot] = None

    @torch.inference_mode()
    def step(self):
        self._admit()
        active = [i for i, s in enumerate(self._slots) if s is not None]
        if not active:
            return
        t0 = time.perf_counter()
        toks = torch.as_tensor(self._last_tok, device=self.device)[:, None]
        pos = torch.as_tensor(self._pos, device=self.device)
        logits, self._caches = lm.decode_step(self.cfg, self.params,
                                              self._caches, toks, pos)
        nxt = self._sample(logits)
        self.stats.decode_steps += 1
        self.stats.decode_s += time.perf_counter() - t0
        self.stats.decode_tokens += len(active)
        for i in active:
            req = self._slots[i]
            req.generated.append(int(nxt[i]))
            self._pos[i] += 1
            self._last_tok[i] = int(nxt[i])
            stop = len(req.generated) >= self.scfg.max_new_tokens or (
                self.scfg.eos_id >= 0 and int(nxt[i]) == self.scfg.eos_id
            )
            if stop or self._pos[i] >= self.scfg.cache_len - 1:
                self._retire(i)
