"""RealBackend — PyTorch model execution behind the serving control plane.

Counterpart of ``repro/serving/realengine.py`` for the dense memory
model (``paged=False``): a drop-in for
:class:`~repro_torch.serving.engine.SimBackend` that also runs real
forwards, on the card by default.  Prefill runs B=1 with the prompt
padded to a power-of-two bucket (clamped to ``max_len``) and hands a
per-request dense KV cache to the decode instance with the request;
decode scatters requests into slots of a ``slots × max_len`` ring cache.

The **virtual clock still advances by the hardware model's time**, so
latency/energy results are identical to the Sim backend's; only token
content is real.  Times and energy the cluster reports are that model's
(an A100 by default), not measurements of the card running the tokens.

**Async dispatch.**  A decode step returns token ids that stay on the
device as the next step's input; host emission into
``Request.output_tokens`` waits until the ids are read: once
``pipeline_depth`` steps are in flight (oldest first), at a slot
insert/release, or at the cluster's end-of-run ``flush``.  Control
decisions never read token content, so deferral reorders nothing.

The paged pool (ROADMAP queue 1, item 4), speculative decoding (item 5)
and mesh slices (item 8) are not ported yet and raise.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.hwmodel import HardwareModel
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as M
from repro_torch.serving import jitcache
from repro_torch.serving.engine import SimBackend
from repro_torch.serving.request import Request


def _bucket(n: int, lo: int = 16, hi: Optional[int] = None) -> int:
    """Power-of-two padding bucket, clamped to the cache capacity: a
    70-token prompt with ``max_len=96`` pads to 96, not to an impossible
    128 (capacity itself is checked separately, on the *token* count)."""
    b = lo
    while b < n:
        b *= 2
    if hi is not None:
        b = min(b, hi)
    return b


def _not_ported(paged: bool, spec_k: int, tp: int) -> None:
    if paged:
        raise NotImplementedError(
            "paged KV serving is ROADMAP queue 1, item 4 of the port"
        )
    if spec_k > 0:
        raise NotImplementedError(
            "speculative draft-verify is ROADMAP queue 1, item 5 of the port"
        )
    if tp > 0:
        raise NotImplementedError(
            "mesh-sliced instances are ROADMAP queue 1, item 8 of the port"
        )


class RealBackend(SimBackend):
    """Executes real PyTorch forwards; inherits Sim timing/energy accounting."""

    def __init__(
        self,
        hw: HardwareModel,
        cfg: ModelConfig,
        params,
        *,
        slots: int = 8,
        max_len: int = 256,
        noise_sigma: float = 0.0,
        seed: int = 0,
        paged: bool = False,
        spec_k: int = 0,
        pipeline_depth: int = 1,
        device: DeviceLike = None,
    ):
        _not_ported(paged, spec_k, 0)
        super().__init__(hw, noise_sigma, seed)
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.device = resolve_device(device)
        # decode slot state.  The token chain is device-resident: the
        # previous iteration's greedy ids feed the next step without a
        # host round trip.
        self.slot_of: Dict[int, int] = {}  # rid -> slot
        self.free = list(range(slots))[::-1]
        self._next_dev = torch.zeros(slots, dtype=torch.int32,
                                     device=self.device)
        self.pos = np.zeros(slots, np.int32)
        # deferred emissions from in-flight decode steps: a bounded ring
        # of up to ``pipeline_depth`` iterations.  Dispatch only blocks
        # (drains the oldest entry) once the ring is full;
        # insert/release/flush drain everything.
        if pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {pipeline_depth}"
            )
        self.pipeline_depth = pipeline_depth
        self._ring: Deque[Tuple] = deque()

        self.cache = M.init_cache(cfg, slots, max_len, self.device)
        self._prefill_fn = jitcache.shared_entry(
            M.prefill_greedy, cfg, max_len=max_len
        )
        self._decode_fn = jitcache.shared_entry(M.decode_step_greedy, cfg)

    # ------------------------------------------------------------------
    # Deferred emission (async dispatch)
    # ------------------------------------------------------------------
    def _drain_one(self) -> None:
        """Materialize the *oldest* in-flight iteration's token ids and
        emit them into the requests' output streams.  This is the
        **only** place the host blocks on device results — called when
        the ring reaches ``pipeline_depth`` at dispatch, at a slot
        insert/release, or the end-of-run flush.  Oldest-first order
        keeps each request's stream append-ordered."""
        pairs, ids = self._ring.popleft()
        nxt = ids.cpu().numpy()
        for r, s in pairs:
            r.output_tokens.append(int(nxt[s]))

    def _drain(self) -> None:
        """Drain the whole ring, in dispatch order."""
        while self._ring:
            self._drain_one()

    def flush(self) -> None:
        """Emit every deferred token (cluster end-of-run hook)."""
        self._drain()

    # ------------------------------------------------------------------
    # Prefill: real first token + cache handoff
    # ------------------------------------------------------------------
    def _padded(self, toks: np.ndarray) -> torch.Tensor:
        """The single pad policy: power-of-two bucket clamped to the
        cache capacity, so steady state replays a bounded shape set."""
        pad = _bucket(len(toks), hi=self.max_len)
        buf = np.zeros((1, pad), np.int32)
        buf[0, : len(toks)] = toks
        return torch.from_numpy(buf).to(self.device)

    def _context_tokens(self, r: Request) -> np.ndarray:
        ctx = list(r.prompt_tokens)
        if r.resuming:
            # preemption resume: recompute the KV of prompt + the tokens
            # already delivered (their ids are real and kept); the first
            # token was emitted long ago and must not be re-emitted
            ctx += [int(t) for t in r.output_tokens[: r.tokens_out]]
        return np.asarray(ctx, np.int32)

    def _real_prefill(self, r: Request) -> None:
        toks = self._context_tokens(r)
        if len(toks) > self.max_len:
            raise ValueError(
                f"request {r.rid}: prompt+context of {len(toks)} tokens "
                f"exceeds the decode cache capacity ({self.max_len}); "
                "admission must reject or truncate it upstream"
            )
        self._real_prefill_dense(r, toks)

    def _real_prefill_dense(self, r: Request, toks: np.ndarray) -> None:
        ids, cache = self._prefill_fn(
            self.params,
            tokens=self._padded(toks),
            lengths=torch.tensor([len(toks)], dtype=torch.int32,
                                 device=self.device),
        )
        if not r.resuming:
            r.output_tokens.append(int(ids[0]))
        r.kv_handoff = cache  # migrates with the request (P -> D)

    def prefill_iter(self, reqs: List[Request], n_tok: int, f: float):
        for r in reqs:
            self._real_prefill(r)
        return super().prefill_iter(reqs, n_tok, f)

    def prefill_chunk(self, reqs: List[Request], takes, n_new: int,
                      n_ctx: int, f: float):
        """Chunked scheduling over real compute: the virtual clock/energy
        price each chunk, but the forward runs whole on the *final* chunk."""
        for r, take in zip(reqs, takes):
            if take >= r.prefill_remaining:
                self._real_prefill(r)
        return super().prefill_chunk(reqs, takes, n_new, n_ctx, f)

    # ------------------------------------------------------------------
    # Decode: slot insert / batched step / release
    # ------------------------------------------------------------------
    def insert(self, req: Request) -> None:
        if not self.free:
            raise RuntimeError("no free decode slots (max_running too high?)")
        self._drain()  # the joining token seeds the device chain below
        slot = self.free.pop()
        self.slot_of[req.rid] = slot
        handoff, req.kv_handoff = req.kv_handoff, None
        for name, entry in self.cache.items():
            for key, dst in entry.items():
                # dst: (n_blocks, slots, ...); src: (n_blocks, 1, ...)
                dst[:, slot] = handoff[name][key][:, 0]
        # a fresh tensor: in-flight steps may still hold the old chain
        self._next_dev = self._next_dev.clone()
        self._next_dev[slot] = int(req.output_tokens[-1])
        # resident context = prompt + tokens regenerated before a
        # preemption (fresh requests: tokens_out == 0)
        self.pos[slot] = req.prompt_len + req.tokens_out

    def release(self, req: Request) -> None:
        # materialize in-flight tokens first: the released request's
        # stream is read immediately (finish, or preemption resume)
        self._drain()
        slot = self.slot_of.pop(req.rid)
        self.free.append(slot)

    def _real_decode_step(self, reqs: List[Request]) -> None:
        # bounded depth: block only once pipeline_depth iterations are
        # in flight, and then only on the oldest (depth=1: the previous)
        while len(self._ring) >= self.pipeline_depth:
            self._drain_one()
        ids, self.cache = self._decode_fn(
            self.params,
            tokens=self._next_dev,
            cache=self.cache,
            lengths=torch.from_numpy(self.pos.copy()).to(self.device),
        )
        # chain on device; emission of `ids` waits for the next drain
        self._next_dev = ids
        pairs = []
        for r in reqs:
            s = self.slot_of[r.rid]
            pairs.append((r, s))
            self.pos[s] += 1
        self._ring.append((pairs, ids))

    def decode_iter(self, reqs: List[Request], n_req: int, n_kv: int,
                    f: float):
        if reqs:
            self._real_decode_step(reqs)
        return super().decode_iter(reqs, n_req, n_kv, f)

    def hybrid_iter(self, dec_reqs: List[Request], n_req: int, n_kv: int,
                    pre_reqs: List[Request], takes, n_new: int,
                    n_ctx: int, f: float):
        if dec_reqs:
            self._real_decode_step(dec_reqs)
        for r, take in zip(pre_reqs, takes):
            if take >= r.prefill_remaining:
                self._real_prefill(r)
        return super().hybrid_iter(
            dec_reqs, n_req, n_kv, pre_reqs, takes, n_new, n_ctx, f
        )


def make_real_backend_factory(
    cfg: ModelConfig,
    params,
    *,
    slots: int = 8,
    max_len: int = 256,
    paged: bool = False,
    spec_k: int = 0,
    tp: int = 0,
    pipeline_depth: int = 1,
    device: DeviceLike = None,
):
    """Factory for ClusterConfig.backend_factory: every instance gets its
    own slot state but shares the (read-only) weights and — via
    :mod:`repro_torch.serving.jitcache` — the entry points and their
    compile telemetry.  ``pipeline_depth`` sets each instance's
    async-dispatch window; token streams are identical at every depth.
    ``device`` defaults to the card."""
    _not_ported(paged, spec_k, tp)
    dev = resolve_device(device)

    def factory(kind: str, idx: int, hw: HardwareModel, seed: int,
                tp: Optional[int] = None):
        # tp: the cluster's per-instance degree; one device per instance
        n_slots = slots if kind in ("decode", "hybrid") else 1
        return RealBackend(
            hw, cfg, params, slots=n_slots, max_len=max_len, seed=seed,
            pipeline_depth=pipeline_depth, device=dev,
        )

    return factory
