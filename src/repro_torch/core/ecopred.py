"""EcoPred — online-adaptive, load-aware latency prediction (paper §V-D).

Two models, exactly the paper's Eqs. 8-9 and Appx. C:

    T_P(M, B, f) = model_P(f, N_tok)            (gblinear, MAE objective)
    T_D(M, B, f) = model_D(f, N_req, N_kv)      (gbtree,   MAE objective)

Lifecycle (paper Fig. 12):

1. **Offline profiling** — uniform, distribution-agnostic sampling over the
   feasible ``(f, N_tok)`` / ``(f, N_req, N_kv)`` ranges against a latency
   oracle (on real hardware: measured; here: the roofline-calibrated
   :class:`~repro.core.hwmodel.HardwareModel` plus measurement noise).
2. **Online adaptation** — the engine records ``(features, measured_time)``
   for every iteration; every ``adapt_every`` new samples a background
   fine-tune (``continue_fit``) absorbs the offline->online distribution
   shift. Samples are kept in a bounded replay window.

Prediction is vectorized so EcoRoute's what-if queries over all candidate
decode instances batch into one call (paper §V-E: "multiple queries ...
are batched together").
"""
from __future__ import annotations

from bisect import bisect_right
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.core.gbdt import GBLinear, GBTree
from repro_torch.core.hwmodel import HardwareModel


@dataclass
class ProfileRanges:
    """Feasible feature ranges for offline uniform profiling."""

    max_tokens: int = 16_384  # prefill batched-token budget
    max_requests: int = 512  # decode running-request cap
    max_kv_tokens: int = 1_000_000  # KV-cache token capacity
    max_cached_tokens: int = 16_384  # resident-prefix range (chunk/cache)


class EcoPred:
    """Prefill + decode inference-time predictors with online adaptation."""

    def __init__(
        self,
        freq_options: Sequence[float],
        adapt_every: int = 512,
        replay_window: int = 8_192,
        seed: int = 0,
    ):
        self.freq_options = tuple(sorted(set(freq_options)))
        self.adapt_every = adapt_every
        self.replay_window = replay_window
        self._rng = np.random.default_rng(seed)
        self.prefill_model = GBLinear(n_rounds=60, learning_rate=0.5,
                                      objective="mae")
        self.decode_model = GBTree(
            n_estimators=300, learning_rate=0.1, max_depth=6,
            subsample=0.8, colsample=1.0, objective="mae",
            early_stopping_rounds=50, seed=seed,
        )
        self._buf_p: List[np.ndarray] = []
        self._buf_d: List[np.ndarray] = []
        self._buf_v: List[np.ndarray] = []
        self._since_p = 0
        self._since_d = 0
        self._since_v = 0
        self.n_adaptations = 0
        self.online_enabled = True
        # bin-edge lists for the scalar bin-key path, cached per model
        # version (np.searchsorted is ~10× slower than bisect for one
        # scalar, and the select memo asks per iteration)
        self._edge_cache: dict = {}
        # speculative-verify latency model over (f, N_req, N_kv, k):
        # fitted lazily (ensure_verify_profile) so legacy clusters never
        # pay for — or observe — the extra model
        self.verify_model: Optional[GBTree] = None
        self._verify_seed = seed

    # ------------------------------------------------------------------
    # Offline profiling (paper: measured profiles; here: hwmodel + noise)
    # ------------------------------------------------------------------
    def offline_profile(
        self,
        hw: HardwareModel,
        ranges: Optional[ProfileRanges] = None,
        n_prefill: int = 2_000,
        n_decode: int = 6_000,
        noise_sigma: float = 0.03,
        seed: int = 1,
    ) -> "EcoPred":
        r = ranges or ProfileRanges()
        rng = np.random.default_rng(seed)
        freqs = np.asarray(self.freq_options)

        # prefill: uniform over (N_new, N_cached), uniform over frequency
        # options.  Half the samples keep N_cached == 0 so the legacy
        # whole-prompt query stays exactly on-distribution; the rest cover
        # chunked/partial prefill (a chunk of new tokens attending to a
        # resident prefix of cache hits + earlier chunks).
        n_tok = rng.integers(1, r.max_tokens + 1, n_prefill)
        n_cached = rng.integers(0, r.max_cached_tokens + 1, n_prefill)
        n_cached[: n_prefill // 2] = 0
        f_p = freqs[rng.integers(0, len(freqs), n_prefill)]
        # one array-native pricing call per lane kind (chunked vs whole
        # prompt) instead of n_prefill scalar oracle calls — bit-identical
        # to the scalar loop by the *_iter_batch contract
        y_p = np.empty(n_prefill)
        chunked = n_cached > 0
        if chunked.any():
            y_p[chunked] = hw.prefill_chunk_iter_batch(
                n_tok[chunked], n_cached[chunked], 1, f_p[chunked]
            ).time_s
        whole = ~chunked
        if whole.any():
            y_p[whole] = hw.prefill_iter_batch(
                n_tok[whole], None, f_p[whole]
            ).time_s
        y_p *= np.exp(rng.normal(0.0, noise_sigma, n_prefill))
        self.prefill_model.fit(self._pfeat(f_p, n_tok, n_cached), y_p)

        # decode: uniform over (N_req, N_kv) with N_kv >= N_req
        n_req = rng.integers(1, r.max_requests + 1, n_decode)
        n_kv = np.minimum(
            r.max_kv_tokens,
            n_req * rng.uniform(1.0, r.max_kv_tokens /
                                np.maximum(n_req, 1), n_decode),
        ).astype(int)
        f_d = freqs[rng.integers(0, len(freqs), n_decode)]
        y_d = hw.decode_iter_batch(n_req, n_kv, f_d).time_s.copy()
        y_d *= np.exp(rng.normal(0.0, noise_sigma, n_decode))
        Xd = np.stack([f_d, n_req.astype(float), n_kv.astype(float)], axis=1)
        cut = int(0.9 * n_decode)
        self.decode_model.fit(
            Xd[:cut], y_d[:cut], eval_set=(Xd[cut:], y_d[cut:])
        )
        return self

    # ------------------------------------------------------------------
    # Speculative-verify profiling (lazy; only spec-decode clusters pay)
    # ------------------------------------------------------------------
    def ensure_verify_profile(
        self,
        hw: HardwareModel,
        k_options: Sequence[int] = (1, 2, 4, 8),
        draft_frac: float = 0.05,
        ranges: Optional[ProfileRanges] = None,
        n_samples: int = 6_000,
        noise_sigma: float = 0.03,
    ) -> "EcoPred":
        """Fit the verify-iteration model ``T_V(f, N_req, N_kv, k)``
        against the hardware oracle's full speculative iteration cost
        (draft steps + multi-token verify).  Idempotent: a bank-shared
        predictor is profiled once and reused across runs; the legacy
        prefill/decode models are untouched, so ``spec_decode=False``
        behavior stays bit-exact."""
        if self.verify_model is not None:
            return self
        r = ranges or ProfileRanges()
        rng = np.random.default_rng(self._verify_seed + 17)
        freqs = np.asarray(self.freq_options)
        ks = np.asarray(sorted(set(int(k) for k in k_options)))
        n_req = rng.integers(1, r.max_requests + 1, n_samples)
        n_kv = np.minimum(
            r.max_kv_tokens,
            n_req * rng.uniform(1.0, r.max_kv_tokens /
                                np.maximum(n_req, 1), n_samples),
        ).astype(int)
        f_v = freqs[rng.integers(0, len(freqs), n_samples)]
        k_v = ks[rng.integers(0, len(ks), n_samples)]
        y = hw.spec_decode_iter_batch(
            n_req, n_kv, k_v, draft_frac, f_v
        ).time_s.copy()
        y *= np.exp(rng.normal(0.0, noise_sigma, n_samples))
        X = np.stack(
            [f_v, n_req.astype(float), n_kv.astype(float),
             k_v.astype(float)], axis=1,
        )
        self.verify_model = GBTree(
            n_estimators=300, learning_rate=0.1, max_depth=6,
            subsample=0.8, colsample=1.0, objective="mae",
            early_stopping_rounds=50, seed=self._verify_seed,
        )
        cut = int(0.9 * n_samples)
        self.verify_model.fit(
            X[:cut], y[:cut], eval_set=(X[cut:], y[cut:])
        )
        return self

    # ------------------------------------------------------------------
    # Prediction (vectorized; <0.5 ms per batched query in the paper)
    # ------------------------------------------------------------------
    @staticmethod
    def _pfeat(f, n_tok, n_cached=0) -> np.ndarray:
        """Prefill features over (new tokens, cached/resident context).

        The paper's Eq. 6 per-frequency affine form T ≈ a_f·N_tok + b_f is
        captured exactly by the physical interaction terms N_tok/f and 1/f
        (T_comp ∝ N_tok/f).  Chunked prefill adds the resident prefix c:
        attention FLOPs scale with N_tok·(c + N_tok/2)/f and the prefix KV
        read with c alone, so the cross term, the quadratic term, and the
        bare c all enter as explicit features (GBLinear is linear —
        interactions must be spelled out; without N_tok²/f the fit clamps
        small-chunk/large-prefix queries to zero)."""
        f, t, c = np.broadcast_arrays(
            np.asarray(f, float).ravel(),
            np.asarray(n_tok, float).ravel(),
            np.asarray(n_cached, float).ravel(),
        )
        return np.stack(
            [f, t, t / f * 1e3, 1e3 / f, c, c / f * 1e3,
             t * c / f * 1e-3, t * t / f * 1e-3],
            axis=-1,
        )

    def predict_prefill(self, f, n_tok, n_cached=0) -> np.ndarray:
        return np.maximum(
            self.prefill_model.predict(self._pfeat(f, n_tok, n_cached)), 0.0
        )

    def predict_decode(self, f, n_req, n_kv) -> np.ndarray:
        # hand-rolled broadcast into one (n, 3) buffer: this is the
        # event loop's hottest query (every EcoFreq ladder scan plus the
        # per-iteration straggler-bias re-predict route through here)
        f = np.asarray(f, float)
        q = np.asarray(n_req, float)
        k = np.asarray(n_kv, float)
        shape = np.broadcast_shapes(f.shape, q.shape, k.shape)
        X = np.empty(shape + (3,))
        X[..., 0] = f
        X[..., 1] = q
        X[..., 2] = k
        return np.maximum(
            self.decode_model.predict(X.reshape(-1, 3)), 0.0
        )

    def predict_verify(self, f, n_req, n_kv, k) -> np.ndarray:
        """Predicted wall time of one speculative iteration (draft +
        k-token verify).  ``k == 0`` rows fall back to the plain decode
        model — the verify model is trained on real speculation windows
        only, and extrapolating it to k=0 would bypass the calibrated
        decode fit."""
        if self.verify_model is None:
            raise RuntimeError(
                "verify model not profiled — call ensure_verify_profile() "
                "(the cluster does this when spec_decode=True)"
            )
        f = np.asarray(f, float)
        q = np.asarray(n_req, float)
        c = np.asarray(n_kv, float)
        kk = np.asarray(k, float)
        shape = np.broadcast_shapes(f.shape, q.shape, c.shape, kk.shape)
        X = np.empty(shape + (4,))
        X[..., 0] = f
        X[..., 1] = q
        X[..., 2] = c
        X[..., 3] = kk
        X = X.reshape(-1, 4)
        out = np.maximum(self.verify_model.predict(X), 0.0)
        plain = X[:, 3] == 0.0
        if plain.any():
            out[plain] = np.maximum(
                self.decode_model.predict(X[plain, :3]), 0.0
            )
        return out

    # ------------------------------------------------------------------
    # Scalar fast paths (the per-event straggler-bias re-predict at
    # _D_DONE is one state, one frequency — array plumbing dominated the
    # model walk).  Bin the three/four features with ``bisect`` and
    # answer straight from the GBTree row memo; any miss falls through to
    # the vectorized path, which fills the memo.  Bit-identical to
    # ``float(predict_*(...)[0])`` because GBTree predictions are a pure
    # function of the binned row.
    # ------------------------------------------------------------------
    def predict_decode_scalar(self, f: float, n_req, n_kv) -> float:
        m = self.decode_model
        if m.trees:
            e = self._edges(m, "d")
            v = m._memo.get(bytes((
                bisect_right(e[0], float(f)),
                bisect_right(e[1], float(n_req)),
                bisect_right(e[2], float(n_kv)),
            )))
            if v is not None:
                m.memo_hits += 1
                return float(v) if v > 0.0 else 0.0
        return float(self.predict_decode(f, n_req, n_kv)[0])

    def predict_verify_scalar(self, f: float, n_req, n_kv, k) -> float:
        if self.verify_model is None:
            raise RuntimeError(
                "verify model not profiled — call ensure_verify_profile() "
                "(the cluster does this when spec_decode=True)"
            )
        if float(k) == 0.0:  # k==0 rides the calibrated decode fit
            return self.predict_decode_scalar(f, n_req, n_kv)
        m = self.verify_model
        if m.trees:
            e = self._edges(m, "v")
            v = m._memo.get(bytes((
                bisect_right(e[0], float(f)),
                bisect_right(e[1], float(n_req)),
                bisect_right(e[2], float(n_kv)),
                bisect_right(e[3], float(k)),
            )))
            if v is not None:
                m.memo_hits += 1
                return float(v) if v > 0.0 else 0.0
        return float(self.predict_verify(f, n_req, n_kv, k)[0])

    # ------------------------------------------------------------------
    # Matrix what-ifs (paper §V-E: "multiple queries ... are batched
    # together") — one (n_states × n_ladder) feature matrix per decision,
    # answered by a single model call.  Rows are binned/evaluated
    # independently by both model families, so these are bit-identical
    # to the equivalent scalar loops.
    # ------------------------------------------------------------------
    def predict_prefill_matrix(self, freqs, n_tok, n_cached=0) -> np.ndarray:
        """``(n, k)`` prefill what-ifs: rows are ``(n_tok, n_cached)``
        states, columns the frequency ladder.

        Evaluated one ladder-row at a time on purpose: BLAS gemv results
        are shape-dependent at the ULP level, so collapsing states into
        one ``(n·k, d)`` GEMM would *not* be bit-identical to the scalar
        :meth:`predict_prefill` loop it replaces (the tree models don't
        have this problem — binning makes them exactly row-independent)."""
        fr = np.asarray(freqs, np.float64).ravel()
        t = np.asarray(n_tok, np.float64).ravel()
        c = np.broadcast_to(
            np.asarray(n_cached, np.float64), t.shape
        ).ravel()
        k = fr.size
        out = np.empty((t.size, k))
        for i in range(t.size):
            out[i] = self.prefill_model.predict(
                self._pfeat(fr, np.full(k, t[i]), np.full(k, c[i]))
            )
        return np.maximum(out, 0.0)

    def predict_decode_matrix(self, freqs, n_req, n_kv) -> np.ndarray:
        """``(n, k)`` decode what-ifs: rows are ``(n_req, n_kv)`` states,
        columns the frequency ladder."""
        fr = np.asarray(freqs, np.float64).ravel()
        q = np.asarray(n_req, np.float64).ravel()
        c = np.asarray(n_kv, np.float64).ravel()
        n, k = q.size, fr.size
        X = np.empty((n * k, 3))
        X[:, 0] = np.tile(fr, n)
        X[:, 1] = np.repeat(q, k)
        X[:, 2] = np.repeat(c, k)
        return np.maximum(
            self.decode_model.predict_f64(X), 0.0
        ).reshape(n, k)

    def predict_verify_matrix(self, freqs, n_req, n_kv, k) -> np.ndarray:
        """``(n, k_ladder)`` speculative-iteration what-ifs; per-row
        ``k == 0`` states fall back to the plain decode model exactly
        like :meth:`predict_verify`."""
        if self.verify_model is None:
            raise RuntimeError(
                "verify model not profiled — call ensure_verify_profile() "
                "(the cluster does this when spec_decode=True)"
            )
        fr = np.asarray(freqs, np.float64).ravel()
        q = np.asarray(n_req, np.float64).ravel()
        c = np.asarray(n_kv, np.float64).ravel()
        kk = np.broadcast_to(np.asarray(k, np.float64), q.shape).ravel()
        n, nl = q.size, fr.size
        X = np.empty((n * nl, 4))
        X[:, 0] = np.tile(fr, n)
        X[:, 1] = np.repeat(q, nl)
        X[:, 2] = np.repeat(c, nl)
        X[:, 3] = np.repeat(kk, nl)
        out = np.maximum(self.verify_model.predict_f64(X), 0.0)
        plain = X[:, 3] == 0.0
        if plain.any():
            out[plain] = np.maximum(
                self.decode_model.predict_f64(
                    np.ascontiguousarray(X[plain, :3])
                ),
                0.0,
            )
        return out.reshape(n, nl)

    # ------------------------------------------------------------------
    # Decision-memo support: model-mutation version + bin coordinates
    # ------------------------------------------------------------------
    @property
    def version(self) -> int:
        """Monotone counter bumped whenever any underlying model refits
        (offline profile, online ``continue_fit``, lazy verify profile).
        Decision memos key on it to stay coherent without references."""
        v = self.prefill_model.version + self.decode_model.version
        if self.verify_model is not None:
            v += 1 + self.verify_model.version
        return v

    def _edges(self, model, tag: str) -> list:
        """``model.bin_edges_`` as plain float lists, re-extracted when
        the model refits.  ``bisect`` over a list matches
        ``np.searchsorted(..., side="right")`` exactly (same comparison
        on the same float64 values) at a fraction of the per-call cost."""
        key = (tag, model.version)
        ed = self._edge_cache.get(key)
        if ed is None:
            self._edge_cache.clear()  # at most one live version per model
            ed = [e.tolist() for e in model.bin_edges_]
            self._edge_cache[key] = ed
        return ed

    def decode_bin_key(self, n_req, n_kv) -> tuple:
        """Quantile-bin coordinates of a decode state.  GBTree predictions
        are constant within a bin cell, so two states sharing this key are
        *guaranteed* identical ladder predictions — the foundation of the
        EcoFreq select memo."""
        e = self._edges(self.decode_model, "d")
        return (
            bisect_right(e[1], float(n_req)),
            bisect_right(e[2], float(n_kv)),
        )

    def verify_bin_key(self, n_req, n_kv, k) -> tuple:
        """Bin coordinates of a speculative-verify state (see
        :meth:`decode_bin_key`)."""
        e = self._edges(self.verify_model, "v")
        return (
            bisect_right(e[1], float(n_req)),
            bisect_right(e[2], float(n_kv)),
            bisect_right(e[3], float(k)),
        )

    # ------------------------------------------------------------------
    # Online adaptation
    # ------------------------------------------------------------------
    def record_prefill(
        self, f: float, n_tok: int, t_s: float, n_cached: int = 0
    ) -> None:
        if not self.online_enabled:
            return
        self._buf_p.append(np.array([f, n_tok, n_cached, t_s]))
        self._since_p += 1
        if self._since_p >= self.adapt_every:
            self._adapt_prefill()

    def record_decode(
        self, f: float, n_req: int, n_kv: int, t_s: float
    ) -> None:
        if not self.online_enabled:
            return
        self._buf_d.append(np.array([f, n_req, n_kv, t_s]))
        self._since_d += 1
        if self._since_d >= self.adapt_every:
            self._adapt_decode()

    def record_verify(
        self, f: float, n_req: int, n_kv: int, k: int, t_s: float
    ) -> None:
        if not self.online_enabled or self.verify_model is None:
            return
        self._buf_v.append(np.array([f, n_req, n_kv, k, t_s]))
        self._since_v += 1
        if self._since_v >= self.adapt_every:
            self._adapt_verify()

    def _adapt_verify(self) -> None:
        self._since_v = 0
        buf = np.stack(self._buf_v[-self.replay_window:])
        self.verify_model.continue_fit(buf[:, :4], buf[:, 4], n_more=25)
        self.n_adaptations += 1

    def _adapt_prefill(self) -> None:
        self._since_p = 0
        buf = np.stack(self._buf_p[-self.replay_window:])
        self.prefill_model.continue_fit(
            self._pfeat(buf[:, 0], buf[:, 1], buf[:, 2]), buf[:, 3]
        )
        self.n_adaptations += 1

    def _adapt_decode(self) -> None:
        self._since_d = 0
        buf = np.stack(self._buf_d[-self.replay_window:])
        self.decode_model.continue_fit(buf[:, :3], buf[:, 3], n_more=25)
        self.n_adaptations += 1

    def flush_adaptation(self) -> None:
        """Force a fine-tune on whatever is buffered (end-of-window)."""
        if self._buf_p and self._since_p:
            self._adapt_prefill()
        if self._buf_d and self._since_d:
            self._adapt_decode()
        if self._buf_v and self._since_v:
            self._adapt_verify()

    # ------------------------------------------------------------------
    def mae(
        self,
        phase: str,
        oracle: Callable[..., float],
        samples: np.ndarray,
    ) -> float:
        """Mean-absolute-error against an oracle on given feature rows."""
        if phase == "prefill":
            pred = self.predict_prefill(samples[:, 0], samples[:, 1])
            true = np.array(
                [oracle(int(t), float(f)) for f, t in samples]
            )
        else:
            pred = self.predict_decode(
                samples[:, 0], samples[:, 1], samples[:, 2]
            )
            true = np.array(
                [oracle(int(q), int(k), float(f)) for f, q, k in samples]
            )
        return float(np.abs(pred - true).mean())
