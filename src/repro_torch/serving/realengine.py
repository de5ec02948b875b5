"""RealBackend — PyTorch model execution behind the serving control plane.

Counterpart of ``repro/serving/realengine.py``: a drop-in for
:class:`~repro_torch.serving.engine.SimBackend` that also runs real
forwards, on the card by default.  Two memory models, selected by
``paged``:

* **dense** (``paged=False``): prefill runs B=1 with the prompt padded to
  a power-of-two bucket (clamped to ``max_len``) and hands a per-request
  dense cache to the decode instance with the request — a K/V ring per
  attention layer, the conv tail and SSM state per Mamba2 layer; decode
  scatters requests into slots of a ``slots × max_len`` cache and steps
  every slot each iteration.  A recurrent state cannot roll back, so the
  engine's contract that every resident request is in each decode batch
  is what keeps a Mamba2 slot from stepping for a token it never got.
* **paged** (``paged=True``): KV lives in a
  :class:`~repro_torch.serving.kvpool.KVPool` of fixed-size pages backed
  by one ``(pool_pages + 1, page_size, …)`` tensor set per layer
  (:func:`repro_torch.models.model.init_paged_cache`).  Prefill writes
  straight into pool pages; radix prefix hits hand the request the same
  pages (refcount > 1, no recompute); decode grows a per-slot block table
  page by page; the P→D handoff copies the request's pages; release and
  preemption return pages to the pool.  With ``spec_k > 0`` decode
  instances run draft–verify speculation: a small drafter over its own
  ring cache proposes k tokens, one ``verify_step_paged`` forward checks
  them, and pages holding only rejected positions go back to the pool.

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

Caches are updated in place, so the JAX backend's ``donate_kv`` has no
counterpart here.

**Step graphs.**  On the card a meshless backend replays its
decode-shaped steps (decode, paged decode, draft, verify) from CUDA
graphs, one per entry point, captured on first use
(:class:`~repro_torch.serving.jitcache.StepGraph`): the port's
counterpart of the JAX backend's jitted step executables.  Every step
runs all ``slots`` rows at one shape, so a backend holds one graph, or
two when it speculates (the drafter's step and the verify pass).  Prefill stays eager (its shape follows the prompt's bucket), as
do mesh slices (their collectives go through gloo in host memory).
``cuda_graphs=False`` runs every step eagerly: the graphs' parity
oracle.

**Mesh slices.**  With ``mesh`` (a ``DeviceMesh`` slice from
:class:`~repro_torch.distributed.meshslice.MeshSlicer`) the instance
holds this rank's shards of its weights, ring, page pool and drafter
(:func:`~repro_torch.distributed.sharding.place_serving_state`) and its
entry points run in the slice's mesh context.  Every rank of the
``torch.distributed`` world runs the same cluster, and the instance
seed is the same on every rank, so all ranks draw the same speculative
acceptance and take the same decisions.  The port serves slices that
cover the whole world (``tp`` equal to the world size), where every
instance sits on the same ranks and the P→D handoff is a shard-local
copy; disjoint slices, whose handoff crosses ranks, and Mamba2, MoE or
int8 on a mesh wider than 1 raise (ROADMAP queue 1, item 8).

**int8.**  Weights quantized by
:func:`~repro_torch.models.model.quantize_params` are served as they
come (every entry point dequantizes block by block), and
``kv_dtype="int8"`` rings hand their scales over with their codes.  An
encoder fed embeddings (hubert) has no decode phase and is refused.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.hwmodel import HardwareModel
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.context import mesh_context
from repro_torch.distributed.meshslice import MeshSlicer
from repro_torch.models import model as M
from repro_torch.serving import jitcache
from repro_torch.serving.engine import SimBackend
from repro_torch.serving.kvpool import BlockTable, KVPool, PageAllocError
from repro_torch.serving.radixcache import PagedRadixCache
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


def _not_ported(cfg: ModelConfig, tp: int, n_ranks: int) -> None:
    """Reject the mesh slices the port does not serve yet."""
    if 1 <= tp < n_ranks:
        raise NotImplementedError(
            f"a {tp}-wide slice of a {n_ranks}-rank world puts instances on "
            "disjoint ranks, whose P→D handoff crosses ranks: ROADMAP queue "
            "1, item 8 of the port (serve with tp equal to the world size)"
        )
    M._check_mesh(cfg, tp)  # Mamba2, MoE and int8 on a slice


def _check_servable(cfg: ModelConfig) -> None:
    """An encoder fed embeddings (hubert) has no decode phase, so no P/D
    serving: refuse it here, with the reason, before its prefill fails
    for want of a token embedding."""
    if not cfg.embed_inputs:
        raise ValueError(
            f"model '{cfg.name}' is an encoder fed frame embeddings "
            "(embed_inputs=False): it has no token embedding and no decode "
            "phase, so it cannot be served; run it through "
            "repro_torch.models.model.forward(inputs_embeds=...)"
        )


def _put_slot(dst_tree, src_tree, slot: int) -> None:
    """Write a B=1 cache (n_blocks, 1, ...) into ``slot`` of a batched
    one (n_blocks, slots, ...), in place: every leaf alike, whatever the
    layer holds (K/V rings of a windowed and a global capacity, a Mamba2
    conv tail and SSM state)."""
    for name, entry in dst_tree.items():
        for key, dst in entry.items():
            dst[:, slot] = src_tree[name][key][:, 0]


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
        page_size: int = 16,
        pool_pages: Optional[int] = None,
        spec_k: int = 0,
        draft_cfg: Optional[ModelConfig] = None,
        draft_params=None,
        mesh=None,
        pipeline_depth: int = 1,
        device: DeviceLike = None,
        cuda_graphs: Optional[bool] = None,
    ):
        _check_servable(cfg)
        super().__init__(hw, noise_sigma, seed)
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.paged = paged
        self.device = resolve_device(device)
        # mesh slice: this instance's ranks.  None = the meshless path.
        # Caches are allocated inside the slice's mesh context, at this
        # rank's kv heads
        self.mesh = mesh

        def on_slice():
            return (mesh_context(mesh) if mesh is not None
                    else contextlib.nullcontext())

        entry_kw = dict(mesh=mesh) if mesh is not None else {}
        # decode slot state (both memory models batch decode over slots).
        # The token chain is device-resident: the previous iteration's
        # greedy ids feed the next step without a host round trip.
        self.slot_of: Dict[int, int] = {}  # rid -> slot
        self.free = list(range(slots))[::-1]
        self._next_dev = torch.zeros(slots, dtype=torch.int32,
                                     device=self.device)
        self.pos = np.zeros(slots, np.int32)
        # deferred emissions from in-flight decode/spec steps: a bounded
        # ring of up to ``pipeline_depth`` iterations.  Dispatch only
        # blocks (drains the oldest entry) once the ring is full;
        # insert/release/flush drain everything.
        if pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {pipeline_depth}"
            )
        self.pipeline_depth = pipeline_depth
        self._ring: Deque[Tuple] = deque()
        # occupancy telemetry: ring depth summed over dispatches
        self.pipeline_depth_sum = 0
        self.pipeline_dispatches = 0
        self.device_wait_s = 0.0  # host time blocked reading step results
        # decode-shaped steps replay from CUDA graphs (None: on the card
        # without a mesh)
        on_card = jitcache.graphs_available(self.device)
        if cuda_graphs is None:
            cuda_graphs = on_card and mesh is None
        elif cuda_graphs and (mesh is not None or not on_card):
            raise ValueError(
                "cuda_graphs=True needs a meshless backend on the card: a "
                "mesh slice's collectives go through gloo in host memory, "
                "and there are no graphs off the card"
            )
        self._graphs = jitcache.StepGraph(self.device) if cuda_graphs \
            else None

        if paged:
            if max_len % page_size:
                raise ValueError(
                    f"max_len ({max_len}) must be a multiple of page_size "
                    f"({page_size})"
                )
            self.page_size = page_size
            self.max_pages = max_len // page_size
            # worst case: every decode slot at max_len, plus in-flight
            # prefill tables and radix-shared prefix pages
            self.pool_pages = pool_pages or (2 * slots + 8) * self.max_pages
            # the cache first: it rejects recurrent (Mamba) and int8-KV
            # configs before a pool exists
            with on_slice():
                self.kvcache = M.init_paged_cache(cfg, self.pool_pages,
                                                  page_size, self.device)
            self.params = self._place(cfg, params, self.kvcache)
            self.pool = KVPool(self.pool_pages, page_size)
            self.block_tables = np.full((slots, self.max_pages), -1,
                                        np.int32)
            self.table_of: Dict[int, BlockTable] = {}  # rid -> table
            # prefill tables awaiting the radix attach at iteration end
            self._pstash: Dict[int, List[int]] = {}
            self._radix: Optional[PagedRadixCache] = None
            # observability: prefix hits skip real compute
            self.reused_tokens = 0
            self.computed_tokens = 0
            self._prefill_fn = jitcache.shared_entry(
                M.prefill_paged_greedy, cfg, **entry_kw
            )
            self._decode_fn = jitcache.shared_entry(
                M.decode_step_paged_greedy, cfg, **entry_kw
            )
        else:
            with on_slice():
                self.cache = M.init_cache(cfg, slots, max_len, self.device)
            self.params = self._place(cfg, params, self.cache)
            self._prefill_fn = jitcache.shared_entry(
                M.prefill_greedy, cfg, max_len=max_len, **entry_kw
            )
            self._decode_fn = jitcache.shared_entry(
                M.decode_step_greedy, cfg, **entry_kw
            )

        # speculative draft–verify (needs the paged pool: the rollback of
        # rejected draft KV is page bookkeeping)
        self.spec_k = spec_k
        if spec_k > 0:
            if not paged:
                raise ValueError(
                    "real speculative decoding requires paged=True — the "
                    "draft–verify rollback is block-pool page bookkeeping"
                )
            if draft_cfg is None or draft_params is None:
                raise ValueError(
                    "spec_k > 0 needs a draft model (make_draft_config / "
                    "caller-supplied draft_cfg + draft_params)"
                )
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError("draft and target must share a vocabulary")
            self.draft_cfg = draft_cfg
            # the drafter keeps a dense ring cache per decode slot; its
            # "rollback" is implicit (stale positions are masked by the
            # per-slot position array until overwritten)
            with on_slice():
                self.draft_cache = M.init_cache(draft_cfg, slots, max_len,
                                                self.device)
            self.draft_params = self._place(draft_cfg, draft_params,
                                            self.draft_cache)
            self._prev_dev = torch.zeros(slots, dtype=torch.int32,
                                         device=self.device)  # token at pos-1
            self._draft_prefill_fn = jitcache.shared_entry(
                M.prefill_greedy, draft_cfg, max_len=max_len, **entry_kw
            )
            self._draft_fn = jitcache.shared_entry(M.draft_step, draft_cfg,
                                                   **entry_kw)
            self._verify_fn = jitcache.shared_entry(
                M.verify_step_paged_greedy, cfg, **entry_kw
            )
            # token-match telemetry: what greedy accept-prefix sampling
            # would have accepted (the acceptance *realization* is the
            # engine's, backend-independent, so Sim==Real parity holds)
            self.spec_real_matches = 0
            self.spec_real_drafted = 0

    def _place(self, cfg: ModelConfig, params, cache):
        """``params`` on this instance's slice: this rank's shards, after
        a check that ``cache`` was allocated at its local widths."""
        if self.mesh is None:
            return params
        params, _ = SH.place_serving_state(cfg, params, [cache], self.mesh)
        return params

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _step(self, entry, params, **kwargs):
        """One decode-shaped step: replayed from this backend's graph of
        ``entry`` (host arrays copied straight into the graph's buffers),
        or run eagerly."""
        if self._graphs is None:
            return entry(params, **{
                k: self._dev(v) if isinstance(v, np.ndarray) else v
                for k, v in kwargs.items()})
        return self._graphs(entry, params, **{
            k: torch.from_numpy(np.ascontiguousarray(v))
            if isinstance(v, np.ndarray) else v
            for k, v in kwargs.items()})

    # ------------------------------------------------------------------
    # Paged plumbing
    # ------------------------------------------------------------------
    def bind_prefix_cache(self, cache) -> None:
        """Wire the engine's radix cache to this backend's page pool so
        cache nodes can hold page refs (called by the cluster; no-op for
        dense backends or plain token-granular caches).  The cache's
        capacity must fit the pool's spare room after every decode slot
        maxes out: shrinking it quietly would make the Real side evict
        prefixes the Sim side keeps."""
        if not self.paged or not isinstance(cache, PagedRadixCache):
            return
        budget = (self.pool_pages - self.slots * self.max_pages) \
            * self.page_size
        if cache.capacity_tokens > budget:
            raise ValueError(
                f"prefix cache capacity ({cache.capacity_tokens} tokens) "
                f"exceeds the page pool's spare room ({budget} tokens "
                f"after reserving {self.slots} slots × {self.max_len}); "
                "raise pool_pages on make_real_backend_factory or lower "
                "ClusterConfig.prefix_cache_capacity"
            )
        cache.pool = self.pool
        self._radix = cache

    def _evict_radix_for(self, n: int) -> bool:
        """Best-effort: shed cold radix-held pages so ``n`` more can be
        allocated (locked / in-flight pages are pinned and survive).
        Returns False when there is no radix cache to shed from."""
        if self._radix is None:
            return False
        cap0 = self._radix.capacity_tokens
        self._radix.capacity_tokens = max(
            0, self._radix.size_tokens - n * self.page_size
        )
        self._radix._evict_to_fit()
        self._radix.capacity_tokens = cap0
        return True

    def _alloc_pages(self, n: int) -> List[int]:
        """Pool allocation with the radix-shedding fallback; a pool too
        small even then raises PageAllocError (a sizing fault)."""
        try:
            return self.pool.alloc(n)
        except PageAllocError:
            if not self._evict_radix_for(n):
                raise
            return self.pool.alloc(n)

    def prefix_inserted(self, r: Request, cache, now: float) -> None:
        """Engine hook: the prompt just entered the radix cache — attach
        its full pages (the cache takes its own refs), then release the
        in-flight references the prefill stashed."""
        if not self.paged:
            return
        table = self._pstash.pop(r.rid, None)
        if table is None:
            return
        if self._radix is not None and r.prompt_tokens:
            self._radix.attach_pages(r.prompt_tokens, table)
        self.pool.decref(table)

    def abort_prefill(self, reqs: List[Request]) -> None:
        """Engine hook: in-flight prefill lost (failure) — release the
        stashed page references before the requests re-route."""
        if not self.paged:
            return
        for r in reqs:
            table = self._pstash.pop(r.rid, None)
            if table:
                self.pool.decref(table)
            r.kv_handoff = None

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
        p = self._ring.popleft()
        t0 = time.perf_counter()
        if p[0] == "decode":
            _, pairs, ids = p
            nxt = ids.cpu().numpy()
            self.device_wait_s += time.perf_counter() - t0
            for r, s in pairs:
                r.output_tokens.append(int(nxt[s]))
        else:  # spec: accepted draft prefix + bonus/correction token
            _, entries, drafts_dev, tgt_dev, match_dev = p
            drafts = drafts_dev.cpu().numpy()
            tgt = tgt_dev.cpu().numpy()
            match = match_dev.cpu().numpy()
            self.device_wait_s += time.perf_counter() - t0
            for r, s, a in entries:
                r.output_tokens.extend(int(drafts[s, j]) for j in range(a))
                r.output_tokens.append(int(tgt[s, a]))
                self.spec_real_matches += int(match[s])
                self.spec_real_drafted += self.spec_k

    def _drain(self) -> None:
        """Drain the whole ring, in dispatch order."""
        while self._ring:
            self._drain_one()

    def flush(self) -> None:
        """Emit every deferred token (cluster end-of-run hook)."""
        self._drain()

    def _dispatched(self, entry: Tuple) -> None:
        self._ring.append(entry)
        self.pipeline_depth_sum += len(self._ring)
        self.pipeline_dispatches += 1

    # ------------------------------------------------------------------
    # Prefill: real first token + cache handoff
    # ------------------------------------------------------------------
    def _padded(self, toks: np.ndarray) -> torch.Tensor:
        """The single pad policy for every prefill-shaped entry point
        (dense, paged suffix, draft): power-of-two bucket clamped to the
        cache capacity, so steady state replays a bounded shape set."""
        pad = _bucket(len(toks), hi=self.max_len)
        buf = np.zeros((1, pad), np.int32)
        buf[0, : len(toks)] = toks
        return self._dev(buf)

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
        if self.paged:
            self._real_prefill_paged(r, toks)
        else:
            self._real_prefill_dense(r, toks)

    def _real_prefill_dense(self, r: Request, toks: np.ndarray) -> None:
        ids, cache = self._prefill_fn(
            self.params,
            tokens=self._padded(toks),
            lengths=self._dev(np.array([len(toks)], np.int32)),
        )
        if not r.resuming:
            r.output_tokens.append(int(ids[0]))
        r.kv_handoff = cache  # migrates with the request (P -> D)

    def _real_prefill_paged(self, r: Request, toks: np.ndarray) -> None:
        """Prefill into pool pages.  A radix prefix hit contributes its
        resident pages (incref, no recompute); only the suffix runs the
        forward, writing its KV into freshly allocated pages."""
        L = len(toks)
        n_ctx, ctx_pages = 0, []
        if self._radix is not None:
            n_ctx, ctx_pages = self._radix.match_pages(toks.tolist())
        self.pool.incref(ctx_pages)
        try:
            new_pages = self._alloc_pages(
                self.pool.pages_for(L) - len(ctx_pages)
            )
        except PageAllocError:
            self.pool.decref(ctx_pages)
            raise
        table = list(ctx_pages) + new_pages
        S = L - n_ctx
        bt = np.full((1, self.max_pages), -1, np.int32)
        bt[0, : len(table)] = table
        ids, self.kvcache = self._prefill_fn(
            self.params,
            tokens=self._padded(toks[n_ctx:]),
            lengths=self._dev(np.array([S], np.int32)),
            ctx_lens=self._dev(np.array([n_ctx], np.int32)),
            block_tables=self._dev(bt),
            cache=self.kvcache,
        )
        if not r.resuming:
            r.output_tokens.append(int(ids[0]))
        # migration payload: a copy of the request's pages (the pool may
        # hand them out again at once); the decode side scatters them
        # into its own pool
        idx = torch.tensor(table, dtype=torch.long, device=self.device)
        r.kv_handoff = ({
            name: {key: leaf[:, idx] for key, leaf in entry.items()}
            for name, entry in self.kvcache.items()
        }, L)
        self.reused_tokens += n_ctx
        self.computed_tokens += S
        if self._radix is not None and r.prompt_tokens:
            # refs live until the radix attach at iteration end (the
            # engine's prefix_inserted hook) or an abort on failure
            self._pstash[r.rid] = table
        else:
            # no radix to hand the pages to: the handoff copy is taken,
            # release them now
            self.pool.decref(table)

    def prefill_iter(self, reqs: List[Request], n_tok: int, f: float):
        for r in reqs:
            self._real_prefill(r)
        return super().prefill_iter(reqs, n_tok, f)

    def prefill_chunk(self, reqs: List[Request], takes, n_new: int,
                      n_ctx: int, f: float):
        """Chunked scheduling over real compute: the virtual clock/energy
        price each chunk, but the forward runs whole on the *final* chunk
        (dense: the whole prompt; paged: the post-prefix suffix)."""
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
        # on a slice the handoff holds the prefill instance's shards,
        # which are ours: both slices cover the same ranks and cut the
        # heads alike, so the copies below stay shard-local
        if self.paged:
            tree, L = handoff
            table = BlockTable(self.pool)
            table.adopt(self._alloc_pages(self.pool.pages_for(L)), L)
            dst = torch.tensor(table.pages, dtype=torch.long,
                               device=self.device)
            for name, entry in self.kvcache.items():
                for key, leaf in entry.items():
                    # leaf: (n_blocks, P+1, ps, ...); the request's page
                    # stack: (n_blocks, n_pages, ps, ...)
                    leaf[:, dst] = tree[name][key]
            self.table_of[req.rid] = table
            self.block_tables[slot] = -1
            self.block_tables[slot, : len(table.pages)] = table.pages
        else:
            _put_slot(self.cache, handoff, slot)
        # a fresh tensor: in-flight steps may still hold the old chain
        self._next_dev = self._next_dev.clone()
        self._next_dev[slot] = int(req.output_tokens[-1])
        # resident context = prompt + tokens regenerated before a
        # preemption (fresh requests: tokens_out == 0)
        self.pos[slot] = req.prompt_len + req.tokens_out
        if self.spec_k > 0:
            self._draft_prefill(req, slot)

    def _draft_prefill(self, req: Request, slot: int) -> None:
        """Build the drafter's ring cache for a joining request: the draft
        model ingests the context the target holds (prompt plus any
        tokens regenerated after a preemption resume)."""
        toks = self._context_tokens(req)
        _, dcache = self._draft_prefill_fn(
            self.draft_params,
            tokens=self._padded(toks),
            lengths=self._dev(np.array([len(toks)], np.int32)),
        )
        _put_slot(self.draft_cache, dcache, slot)
        self._prev_dev = self._prev_dev.clone()
        self._prev_dev[slot] = int(toks[-1])

    def release(self, req: Request) -> None:
        # materialize in-flight tokens first: the released request's
        # stream is read immediately (finish, or preemption resume)
        self._drain()
        slot = self.slot_of.pop(req.rid)
        self.free.append(slot)
        if self.paged:
            table = self.table_of.pop(req.rid, None)
            if table is not None:
                table.release()
            self.block_tables[slot] = -1

    def _ensure_pages(self, r: Request, need: int) -> None:
        """Grow ``r``'s table to cover ``need`` tokens (shedding radix
        pages if the pool is short) and mirror new pages into the slot's
        block-table row."""
        s = self.slot_of[r.rid]
        table = self.table_of[r.rid]
        try:
            fresh = table.ensure(need)
        except PageAllocError:
            short = self.pool.pages_for(need) - len(table.pages)
            if not self._evict_radix_for(short):
                raise
            fresh = table.ensure(need)
        if fresh:
            n = len(table.pages)
            self.block_tables[s, n - len(fresh): n] = fresh

    def _real_decode_step(self, reqs: List[Request]) -> None:
        # bounded depth: block only once pipeline_depth iterations are
        # in flight, and then only on the oldest (depth=1: the previous)
        while len(self._ring) >= self.pipeline_depth:
            self._drain_one()
        if self.paged:
            # grow tail pages where the next write crosses a boundary
            for r in reqs:
                self._ensure_pages(r, int(self.pos[self.slot_of[r.rid]]) + 1)
            ids, self.kvcache = self._step(
                self._decode_fn, self.params,
                tokens=self._next_dev,
                cache=self.kvcache,
                lengths=self.pos,
                block_tables=self.block_tables,
            )
        else:
            ids, self.cache = self._step(
                self._decode_fn, self.params,
                tokens=self._next_dev,
                cache=self.cache,
                lengths=self.pos,
            )
        # chain on device; emission of `ids` waits for the next drain
        self._next_dev = ids
        pairs = []
        for r in reqs:
            s = self.slot_of[r.rid]
            pairs.append((r, s))
            self.pos[s] += 1
        self._dispatched(("decode", pairs, ids))

    def decode_iter(self, reqs: List[Request], n_req: int, n_kv: int,
                    f: float):
        if reqs:
            self._real_decode_step(reqs)
        return super().decode_iter(reqs, n_req, n_kv, f)

    # ------------------------------------------------------------------
    # Speculative draft–verify (paged)
    # ------------------------------------------------------------------
    def _grow_for_verify(self, r: Request, k: int) -> None:
        """Reserve tail pages for the k+1 tokens the verify forward
        writes (the rejected suffix rolls back after acceptance).  Near
        the slot capacity the window is clamped: positions past
        ``max_len`` have no page and scatter to the scratch page.  Only
        rejected rows can sit there (an accepted token satisfies
        ``pos + a + 1 <= max_len``), and no valid row attends them."""
        need = min(int(self.pos[self.slot_of[r.rid]]) + k + 1, self.max_len)
        self._ensure_pages(r, need)

    def _real_spec_step(self, reqs: List[Request], k: int,
                        accepts: List[int]) -> None:
        """One draft–verify iteration over the paged pool.

        Drafting is k+1 batched draft-model steps: a *sync* step that
        (re-)ingests the token at position ``pos-1`` — idempotent for
        slots already caught up, and exactly the missing ``d_k`` after a
        fully accepted window — then k greedy proposal steps.  The
        target verifies all proposals in one ``verify_step_paged``
        forward; per request the engine's acceptance realization ``a``
        picks the emitted prefix ``d_1..d_a`` plus the verify pass's
        bonus/correction token, and pages holding only rejected
        positions return to the pool (page-exact rollback)."""
        while len(self._ring) >= self.pipeline_depth:
            self._drain_one()
        for r in reqs:
            self._grow_for_verify(r, k)
        # drafting, batched over every slot (free slots write masked
        # garbage into their own rows, never read)
        _, _, self.draft_cache = self._step(
            self._draft_fn, self.draft_params,
            tokens=self._prev_dev,
            cache=self.draft_cache,
            lengths=np.maximum(self.pos - 1, 0),
        )
        props = []
        cur = self._next_dev
        for j in range(k):
            # clamp so a near-capacity slot's ring never wraps: an
            # over-the-end write parks on the last slot, whose true
            # content the next iteration's sync step restores
            prop, _, self.draft_cache = self._step(
                self._draft_fn, self.draft_params,
                tokens=cur,
                cache=self.draft_cache,
                lengths=np.minimum(self.pos + j, self.max_len - 1),
            )
            props.append(prop)
            cur = prop
        drafts = torch.stack(props, dim=1)  # (slots, k), on the device
        # verify: one multi-token forward of [pending, d_1..d_k]
        toks = torch.cat([self._next_dev[:, None], drafts], dim=1)
        tgt, self.kvcache = self._step(
            self._verify_fn, self.params,
            tokens=toks,
            cache=self.kvcache,
            lengths=self.pos,
            block_tables=self.block_tables,
        )
        match = M.accept_prefix(drafts, tgt)
        # chain update on the device with the host-known acceptance
        # realization: prev <- last accepted draft (or the old pending
        # token when a == 0), next <- the bonus/correction token
        a_by_slot = np.zeros(self.slots, np.int64)
        occupied = np.zeros(self.slots, bool)
        entries = []
        for r, a in zip(reqs, accepts):
            s = self.slot_of[r.rid]
            a_by_slot[s] = a
            occupied[s] = True
            entries.append((r, s, a))
        rows = torch.arange(self.slots, device=self.device)
        a_dev = self._dev(a_by_slot)
        occ = self._dev(occupied)
        new_prev = torch.where(
            a_dev > 0, drafts[rows, torch.clamp(a_dev - 1, min=0)],
            self._next_dev,
        )
        self._prev_dev = torch.where(occ, new_prev, self._prev_dev)
        self._next_dev = torch.where(occ, tgt[rows, a_dev], self._next_dev)
        self._dispatched(("spec", entries, drafts, tgt, match))
        for r, s, a in entries:
            self.pos[s] += a + 1
            # page-exact rollback of the rejected suffix
            table = self.table_of[r.rid]
            table.shrink(int(self.pos[s]))
            self.block_tables[s, len(table.pages):] = -1

    def spec_decode_iter(self, reqs: List[Request], n_req: int, n_kv: int,
                         k: int, accepts: List[int], draft_frac: float,
                         f: float):
        if reqs:
            self._real_spec_step(reqs, k, accepts)
        return super().spec_decode_iter(
            reqs, n_req, n_kv, k, accepts, draft_frac, f
        )

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


def make_draft_config(cfg: ModelConfig) -> ModelConfig:
    """A small same-vocab drafter for ``cfg``: one super-block at reduced
    width.  The vocabulary is shared (drafted ids must be the target's)
    and the block pattern is kept so RoPE and windows line up position
    for position."""
    if cfg.has_mamba:
        raise ValueError("draft models cover attention configs")
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-draft",
        n_layers=len(cfg.block_pattern),
        d_model=32,
        n_heads=2,
        n_kv_heads=2,
        head_dim=16,
        d_ff=64 if cfg.d_ff else 0,
    )


def make_real_backend_factory(
    cfg: ModelConfig,
    params,
    *,
    slots: int = 8,
    max_len: int = 256,
    paged: bool = False,
    page_size: int = 16,
    pool_pages: Optional[int] = None,
    spec_k: int = 0,
    draft_cfg: Optional[ModelConfig] = None,
    draft_params=None,
    tp: int = 0,
    devices=None,
    pipeline_depth: int = 1,
    device: DeviceLike = None,
    cuda_graphs: Optional[bool] = None,
):
    """Factory for ClusterConfig.backend_factory: every instance gets its
    own slot/pool state but shares the (read-only) weights and — via
    :mod:`repro_torch.serving.jitcache` — the entry points and their
    compile telemetry.  With ``spec_k > 0`` the decode instances run real
    draft–verify speculation (needs ``paged=True`` and a draft model);
    hybrid instances stay single-token.  ``pipeline_depth`` sets each
    instance's async-dispatch window; token streams are identical at
    every depth.  ``device`` defaults to the card.  ``cuda_graphs``
    (default: on for meshless instances on the card) replays each
    instance's decode-shaped steps from CUDA graphs; ``False`` runs them
    eagerly.

    ``tp > 0`` turns each instance into a **mesh slice**: a
    :class:`~repro_torch.distributed.meshslice.MeshSlicer` over
    ``devices`` (ranks; default: the whole ``torch.distributed`` world)
    carves a ``(1, tp)`` ("data", "model") ``DeviceMesh`` per instance,
    and the cluster's ``InstanceSpec.tp``, passed through the factory's
    ``tp`` keyword, overrides the default degree per instance.  Every
    rank of the world calls the factory in the same order (it runs the
    same cluster).  ``params`` may be full or already this rank's
    shards.  ``tp=0`` is the meshless path."""
    _check_servable(cfg)
    dev = resolve_device(device)
    slicer = None
    if tp or devices is not None:
        slicer = MeshSlicer(devices, device_type=dev.type)
        _not_ported(cfg, tp or 1, slicer.n_devices)
    default_tp = tp
    shards: Dict[tuple, tuple] = {}  # slice -> (params, draft params)

    def factory(kind: str, idx: int, hw: HardwareModel, seed: int,
                tp: Optional[int] = None):
        n_slots = slots if kind in ("decode", "hybrid") else 1
        k = spec_k if kind == "decode" else 0
        mesh, p, dp = None, params, draft_params
        if slicer is not None:
            degree = tp if tp else (default_tp or 1)
            _not_ported(cfg, degree, slicer.n_devices)
            mesh = slicer.slice(degree)
            # one cut per slice, shared by its instances
            key = jitcache.mesh_fingerprint(mesh)
            if key not in shards:
                shards[key] = (
                    SH.shard_params(params, cfg, mesh),
                    draft_params if draft_params is None or not spec_k
                    else SH.shard_params(draft_params, draft_cfg, mesh))
            p, dp = shards[key]
        return RealBackend(
            hw, cfg, p, slots=n_slots, max_len=max_len, seed=seed,
            paged=paged, page_size=page_size, pool_pages=pool_pages,
            spec_k=k, draft_cfg=draft_cfg if k else None,
            draft_params=dp if k else None, mesh=mesh,
            pipeline_depth=pipeline_depth, device=dev,
            cuda_graphs=cuda_graphs,
        )

    return factory
