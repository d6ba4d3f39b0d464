"""The object-oriented facade (counterpart of ``vjf_tpu/api.py``).

A stateful wrapper over the functional core in ``vjf_tpu_torch.models.vjf``
with the reference's user-facing calls: ``VJF.make_model(...)``,
``.fit(...)``, ``.fit_ensemble(...)``, ``.filter(...)``,
``.filter_stream(...)``, ``.forecast(...)``, ``.smooth(...)``,
``.evaluate(...)``, ``.evaluate_kfold(...)``, ``.save``/``.load``. The
model lives on the card unless the caller asks for
``device="cpu"``; where the JAX facade keeps a PRNG key, this one keeps a
CPU ``torch.Generator`` and draws a fresh seed from it for each call.
"""
from __future__ import annotations

import logging
import math
from itertools import repeat
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .config import StepFlags, VJFConfig
from .models import evaluate as EV
from .models import smoothing
from .models import vjf as core
from .models.decoder import decode
from .models.likelihoods import gaussian_lik_update
from .ops import fused_step as _fused
from .ops.functional import finite_or_zero, gaussian_entropy
from .types import Gaussian

_EXHAUSTED = object()  # filter_stream: a side iterable that ran dry

logger = logging.getLogger(__name__)


class VJF:
    """Stateful convenience wrapper; see the module docstring. The
    functional API (``vjf_tpu_torch.models.vjf``) serves custom loops and
    the sharded epoch."""

    def __init__(self, cfg: VJFConfig, seed: int = 0, backend: Optional[str] = None,
                 batch_hint: Optional[int] = None, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("VJF: no CUDA device; pass device='cpu' to run on the CPU")
        self.generator = torch.Generator().manual_seed(int(seed))
        self.state = core.init_state(self._seed(), cfg, device=self.device, backend=backend,
                                     batch_hint=batch_hint)
        self._step_fn = core.filter_step
        self._lr = cfg.lr
        # epochs the latest fit() ran (convergence stops before max_iter)
        self.epochs_run = 0
        # once a fit's warm-up ends the decoder stays frozen
        self._decoder_frozen = False
        self.selected_epoch: Optional[int] = None
        self.selected_metric = float("nan")

    # -- construction -----------------------------------------------------
    @classmethod
    def make_model(cls, ydim: int, xdim: int, udim: int = 0, n_rbf: int = 100,
                   hidden_sizes: Sequence[int] = (20,), likelihood: str = "poisson", *,
                   seed: int = 0, device="cuda", **kwargs) -> "VJF":
        """Factory with the reference's signature (its default likelihood is
        'poisson'); ``kwargs`` are further :class:`VJFConfig` fields."""
        cfg = VJFConfig(ydim=ydim, xdim=xdim, udim=udim, n_rbf=n_rbf,
                        hidden_sizes=tuple(hidden_sizes), likelihood=likelihood.lower(),
                        **kwargs)
        return cls(cfg, seed=seed, device=device)

    def _seed(self) -> int:
        """A fresh seed from the model's generator."""
        return core.epoch_seed(self.generator)

    def _normals(self, n_batch: int) -> torch.Tensor:
        """One step's (2, B, xdim) sampling noise from the model's generator."""
        eps = torch.randn((2, n_batch, self.cfg.xdim), generator=self.generator,
                          dtype=self.cfg.tdtype)
        return eps.to(self.device)

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(device=self.device, dtype=self.cfg.tdtype)

    @_fused.full_f32_matmul()
    def forward(self, y, qs: Optional[Gaussian] = None, u=None) -> Tuple:
        """Forward pass without learning: ``(xs, pt, qt, xt, py)``."""
        cfg = self.cfg
        y = torch.atleast_2d(self._t(y))
        u = None if u is None else torch.atleast_2d(self._t(u))
        if qs is None:
            qs = core.prior(self.state.params, y.shape[0])
        eps = self._normals(y.shape[0])
        with torch.no_grad():
            _, (qt, xt, xs, py, _) = core.elbo_terms(cfg, self.state.params,
                                                     self.state.dynamics, qs, y, u, eps[0],
                                                     eps[1])
            pt = core._transition(cfg).transition_gaussian(self.state.dynamics, xs, u,
                                                           cfg.leak)
        return xs, pt, qt, xt, py

    @_fused.full_f32_matmul()
    def loss(self, y, xs, pt: Gaussian, qt: Gaussian, xt, py,
             warm_up: bool = False) -> torch.Tensor:
        """Negative ELBO from :meth:`forward`'s outputs: recon NLL - entropy
        (+ dynamics NLL unless ``warm_up``), a non-finite term counting as 0.
        ``xs``/``xt`` are taken for the reference's signature and unused."""
        cfg = self.cfg
        del xs, xt
        y = torch.atleast_2d(self._t(y))
        with torch.no_grad():
            loss = (finite_or_zero(core._likelihood_loss(cfg, self.state.params.likelihood,
                                                         py, y))
                    - finite_or_zero(gaussian_entropy(qt)))
            if not warm_up:
                loss = loss + finite_or_zero(core._transition(cfg).dynamics_loss(
                    self.state.dynamics, pt, qt, trace_quirk=cfg.trace_quirk))
        return loss

    # -- streaming filter -------------------------------------------------
    def filter(self, y, u=None, qs: Optional[Gaussian] = None, *, sgd: bool = True,
               update: bool = True, warm_up: bool = False, verbose: bool = False, mask=None,
               channel_mask=None) -> Tuple:
        """One online filter-then-learn step (one autograd ``filter_step``);
        call it again with the returned posterior to stream. Returns ``(qt,
        loss)``, with ``verbose`` also the ELBO terms (recon, dynamics,
        entropy). ``mask``: (B,) 0/1 trial validity (an absent trial leaves
        every sum and its posterior freezes); ``channel_mask``: (B, ydim) 0/1
        missing observations, which may be NaN in ``y``."""
        cfg = self.cfg
        y = torch.atleast_2d(self._t(y))
        u = None if u is None else torch.atleast_2d(self._t(u))
        if qs is None:
            qs = core.prior(self.state.params, y.shape[0])
        if mask is not None:
            mask = torch.atleast_1d(self._t(mask)).expand(y.shape[:1])
        if channel_mask is not None:
            channel_mask = torch.atleast_2d(self._t(channel_mask)).expand(y.shape)
        flags = StepFlags(sgd=sgd, update=update, warm_up=warm_up,
                          train_decoder=not self._decoder_frozen)
        eps = self._normals(y.shape[0])
        lr = _fused._lr_tensor(self._lr, cfg.tdtype, self.device)
        with _fused.full_f32_matmul():
            self.state, qt, metrics = self._step_fn(cfg, flags, self.state, qs, y, u, eps[0],
                                                    eps[1], lr, mask=mask,
                                                    channel_mask=channel_mask)
        if verbose:
            return qt, metrics.loss, metrics.recon, metrics.dynamics, metrics.entropy
        return qt, metrics.loss

    @_fused.full_f32_matmul()
    def update(self, y, xs, u=None, xt=None, py=None, *,
               likelhood: bool = True,           # [sic]: the reference's kwarg name
               likelihood: Optional[bool] = None, decoder: bool = True,
               transition: bool = True, recognition: bool = True,
               warm_up: bool = False) -> None:
        """Gradient-free update with per-module toggles. ``likelhood`` keeps
        the reference's misspelt kwarg; ``likelihood=`` is the corrected
        alias and wins when both are given. ``decoder``/``recognition`` are
        taken and ignored, as in the reference (no closed form exists)."""
        cfg = self.cfg
        lik_on = likelhood if likelihood is None else likelihood
        del decoder, recognition
        y = torch.atleast_2d(self._t(y))
        xs = torch.atleast_2d(self._t(xs))
        xt = xs if xt is None else torch.atleast_2d(self._t(xt))
        u = None if u is None else torch.atleast_2d(self._t(u))
        state = self.state
        with torch.no_grad():
            if lik_on and cfg.likelihood == "gaussian":
                if py is None:
                    py = decode(state.params.decoder, xt)
                new_lik, lik_n = gaussian_lik_update(
                    state.params.likelihood, state.lik_n_sample, py, y,
                    size_cap=cfg.obs_var_cap, logvar_clamp=cfg.logvar_clamp)
                state = state._replace(params=state.params._replace(likelihood=new_lik),
                                       lik_n_sample=lik_n)
            if transition:
                state = state._replace(dynamics=core._transition(cfg).dynamics_update(
                    cfg, state.dynamics, xt, xs, u, warm_up=warm_up))
        self.state = state

    def filter_stream(self, chunks, *, warm_up: bool = False, valid_fn=None, controls=None,
                      masks=None, channel_masks=None, chunks_per_dispatch: int = 1,
                      checkpoint_path: Optional[str] = None, checkpoint_every: int = 0,
                      resume_from: Optional[str] = None):
        """Stream chunks of observations through the filter-then-learn
        epoch, the posterior carried across the chunk boundaries; yields one
        ``EpochResult`` per chunk.

        A chunk is a (chunk_len, B, ydim) array or tensor (e.g. from
        :class:`vjf_tpu_torch.native.StreamingLoader`, staged on the card
        by ``device_prefetch``). It goes to the card in its wire dtype (uint8
        counts at a quarter of the float32 bytes) and is widened there. An
        item may be a ``(chunk, n_valid)`` pair, what
        ``device_prefetch(loader, valid_fn=...)`` yields; otherwise
        ``valid_fn()`` may report the valid steps of the latest chunk. A
        partial final chunk runs its valid steps one :meth:`filter` step at
        a time and ends the stream.

        ``controls`` (required when ``udim > 0``), ``masks`` and
        ``channel_masks`` are iterables of one (chunk_len, B, udim),
        (chunk_len, B) and (chunk_len, B, ydim) or (chunk_len, ydim) item
        per chunk, with ``fit``'s semantics; numpy masks must be 0/1.

        Each chunk draws a fresh seed from the model's generator. Where the
        fused mega layout runs, the first chunk's hot fraction (post-prefix
        steps at the Newton-Schulz skip ceiling) is read at once, and a hot
        first chunk demotes the stream to the autograd epoch and re-runs
        with the same seed; every later chunk's is read one chunk late,
        after the next chunk is enqueued, so the read does not serialise the
        stream; the last one is read when the stream ends and only logged.

        ``chunks_per_dispatch = K > 1``: after the first chunk (which runs
        alone, with the exact-inverse prefix and the synchronous check),
        blocks of K full chunks run through :func:`models.vjf.run_chunks`
        with ``ns_prefix=0``, one mega launch per chunk; each chunk's
        ``EpochResult`` carries the block's final state, and the check is
        per block. A short last block runs as it is.

        ``checkpoint_path`` with ``checkpoint_every=N``: save the whole loop
        state (:class:`models.vjf.StreamSnapshot`) every N or more consumed
        chunks, at chunk (block) boundaries, atomically. ``resume_from``:
        such a snapshot; the caller re-positions ``chunks`` and the side
        iterables at its ``chunks_done``, and the stream continues
        bit-identically. ``warm_up``, ``chunks_per_dispatch`` and the config
        must match the saving run (checked).
        """
        if checkpoint_path is None and checkpoint_every > 0:
            raise ValueError("checkpoint_every requires checkpoint_path")
        if checkpoint_path is not None and checkpoint_every <= 0:
            raise ValueError("checkpoint_path requires checkpoint_every = N > 0 chunks")
        if chunks_per_dispatch > 1:
            yield from self._filter_stream_blocked(
                chunks, int(chunks_per_dispatch), warm_up=warm_up, valid_fn=valid_fn,
                controls=controls, masks=masks, channel_masks=channel_masks,
                checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
                resume_from=resume_from)
            return
        loop = _StreamLoop(self, 1, warm_up, checkpoint_path, checkpoint_every, resume_from)
        flags = loop.flags()
        u_it, m_it, cm_it = self._side_iters(controls, masks, channel_masks)
        for chunk in chunks:
            n_valid_item = None
            if isinstance(chunk, tuple):          # (chunk, n_valid) pair
                chunk, n_valid_item = chunk
            chunk = core.wire_put(chunk, self.cfg.tdtype, self.device)
            t_len = chunk.shape[0]
            uc, m, cm = self._stream_side_next(chunk, u_it, m_it, cm_it, controls, masks,
                                               channel_masks)
            n_valid = (n_valid_item if n_valid_item is not None
                       else valid_fn() if valid_fn is not None else t_len)
            if n_valid < t_len:
                loop.q, tail_res = self._stream_tail(chunk, uc, m, cm, n_valid, warm_up, loop.q)
                if tail_res is not None:
                    yield tail_res
                loop.final_check("the last mega-path chunk's steps")
                return
            yield self._stream_chunk(loop, flags, chunk, uc, m, cm)
        loop.final_check("the last mega-path chunk's steps")

    def _stream_chunk(self, loop, flags, chunk, uc, m, cm):
        """One chunk through ``run_epoch`` with a fresh seed, the posterior
        carried. The previous chunk's check is resolved once this one is
        enqueued; the first checked chunk's is read at once (when hot, the
        stream demotes and the chunk re-runs with the same seed), a later
        one's is left pending."""
        t_len, n_batch = chunk.shape[0], chunk.shape[1]
        us = uc if uc is not None else self._no_controls(t_len, n_batch)
        seed = self._seed()

        def run():
            return core.run_epoch(loop.cfg, flags, self.state, chunk, us, seed, self._lr,
                                  q0=loop.q, mask=m, channel_mask=cm)

        result = run()
        loop.resolve_pending("the previous chunk's steps")
        hot = loop.hot(result.metrics, t_len)
        if hot is not None:
            if loop.first_checked:
                loop.pending_hot = hot
            else:
                loop.first_checked = True
                if loop.demote_now(float(hot), "the first chunk's steps"):
                    result = run()
        self.state = result.state
        loop.q = Gaussian(result.q_means[-1], result.q_logvars[-1])
        loop.advance(1)
        return result

    def _filter_stream_blocked(self, chunks, k_block: int, *, warm_up: bool, valid_fn,
                               controls, masks, channel_masks, checkpoint_path=None,
                               checkpoint_every: int = 0, resume_from=None):
        """The K-chunk mode of :meth:`filter_stream`."""
        loop = _StreamLoop(self, k_block, warm_up, checkpoint_path, checkpoint_every,
                           resume_from)
        flags = loop.flags()
        u_it, m_it, cm_it = self._side_iters(controls, masks, channel_masks)

        def flush(buf):
            """One :func:`run_chunks` over ``len(buf) <= k_block`` chunks.
            Blocks always continue a stream (the first chunk runs alone), so
            the exact-inverse prefix is skipped (``ns_prefix=0``): the
            carried pair has contracted, and the block's hot check still
            guards a change of regime."""
            cfg = loop.cfg
            if all(isinstance(b[0], np.ndarray) for b in buf):
                # host chunks cross to the card as one stacked transfer
                ys = core.wire_put(np.stack([b[0] for b in buf]), cfg.tdtype, self.device)
            else:
                ys = torch.stack([core.wire_put(b[0], cfg.tdtype, self.device) for b in buf])
            us = (torch.stack([b[1] for b in buf]) if buf[0][1] is not None
                  else self._no_controls(*ys.shape[:3]))
            m = torch.stack([b[2] for b in buf]) if buf[0][2] is not None else None
            cm = torch.stack([b[3] for b in buf]) if buf[0][3] is not None else None
            seeds = [self._seed() for _ in buf]
            res = core.run_chunks(cfg.replace(ns_prefix=0), flags, self.state, ys, us, seeds,
                                  self._lr, q0=loop.q, masks=m, channel_masks=cm)
            # the previous block's check, now that this block is enqueued
            loop.resolve_pending("the previous block's post-prefix steps")
            if loop.mega_guard and not warm_up and res.metrics.tau is not None:
                loop.pending_hot = res.hot_frac
            self.state = res.state
            loop.q = res.q_last
            # advance and save before yielding: a consumer that abandons the
            # generator mid-block still finds the boundary's snapshot
            loop.advance(len(buf))
            for i in range(len(buf)):
                yield core.EpochResult(
                    state=self.state, q_means=res.q_means[i], q_logvars=res.q_logvars[i],
                    metrics=core.Metrics(*(None if a is None else a[i] for a in res.metrics)))

        buf, tail = [], None
        for chunk in chunks:
            n_valid_item = None
            if isinstance(chunk, tuple):
                chunk, n_valid_item = chunk
            t_len = chunk.shape[0]
            uc, m, cm = self._stream_side_next(chunk, u_it, m_it, cm_it, controls, masks,
                                               channel_masks)
            n_valid = (n_valid_item if n_valid_item is not None
                       else valid_fn() if valid_fn is not None else t_len)
            if n_valid < t_len:
                tail = (chunk, uc, m, cm, n_valid)
                break
            if not loop.first_checked:
                # the first chunk runs alone, with the exact-inverse prefix
                # (a fresh state's tau is large) and a synchronous check: a
                # hot regime is a property of the workload and shows at once
                result = self._stream_chunk(loop, flags,
                                            core.wire_put(chunk, self.cfg.tdtype, self.device),
                                            uc, m, cm)
                loop.first_checked = True
                yield result
                continue
            buf.append((chunk, uc, m, cm))
            if len(buf) == k_block:
                yield from flush(buf)
                buf = []
        if buf:          # the stream ended inside a block: one shorter block
            yield from flush(buf)
        if tail is not None:
            chunk, uc, m, cm, n_valid = tail
            loop.q, tail_res = self._stream_tail(chunk, uc, m, cm, n_valid, warm_up, loop.q)
            if tail_res is not None:
                yield tail_res
        loop.final_check("the last block's post-prefix steps")

    def _no_controls(self, *shape) -> torch.Tensor:
        return torch.zeros((*shape, 0), dtype=self.cfg.tdtype, device=self.device)

    def _side_iters(self, controls, masks, channel_masks):
        if self.cfg.udim > 0 and controls is None:
            raise ValueError(f"filter_stream: the model has udim={self.cfg.udim}; pass "
                             "`controls=` (one (chunk_len, B, udim) array per chunk)")
        return tuple(iter(it) if it is not None else repeat(None)
                     for it in (controls, masks, channel_masks))

    def _stream_side_next(self, chunk, u_it, m_it, cm_it, controls, masks, channel_masks):
        """The next item of each side iterable, in step with the chunks,
        on the card. Masks travel as 0/1 uint8 and controls no wider than
        the compute dtype; ``run_epoch`` widens them there. Raises where a
        side iterable runs out before the chunks."""
        cfg = self.cfg
        t_len, n_batch = chunk.shape[0], chunk.shape[1]
        uc = next(u_it, _EXHAUSTED) if controls is not None else None
        m = next(m_it, _EXHAUSTED) if masks is not None else None
        cm = next(cm_it, _EXHAUSTED) if channel_masks is not None else None
        if uc is _EXHAUSTED or m is _EXHAUSTED or cm is _EXHAUSTED:
            which = ("controls" if uc is _EXHAUSTED
                     else "masks" if m is _EXHAUSTED else "channel_masks")
            raise ValueError(f"filter_stream: the `{which}` iterable ran out before the "
                             "chunk stream; provide one item per chunk")
        if uc is not None:
            uc = core._promote_u(core.wire_put(uc, cfg.tdtype, self.device), t_len, n_batch,
                                 cfg.tdtype, self.device)
        if m is not None:
            if isinstance(m, np.ndarray):
                m = _binary_u8(m, "masks")
                if m.ndim == 1:
                    m = m[:, None]
                m = core.wire_put(np.broadcast_to(m, (t_len, n_batch)).copy(),
                                  cfg.tdtype, self.device)
            else:
                m = core._promote_mask(m, t_len, n_batch, cfg.tdtype, self.device)
        if cm is not None:
            shape = tuple(chunk.shape)
            if isinstance(cm, np.ndarray):
                cm = _binary_u8(cm, "channel_masks")
                if cm.ndim == 2:
                    cm = cm[:, None, :]
                cm = core.wire_put(np.broadcast_to(cm, shape).copy(),
                                   cfg.tdtype, self.device)
            else:
                cm = core._promote_channel_mask(cm, shape, cfg.tdtype, self.device)
        return uc, m, cm

    def _stream_tail(self, chunk, uc, m, cm, n_valid: int, warm_up: bool, q):
        """The valid steps of a partial last chunk, one :meth:`filter` step
        each (never training on the padding): ``(q, EpochResult | None)``."""
        if n_valid == 0:
            return q, None
        means, logvars, per_step = [], [], []
        for t in range(n_valid):
            q, loss, recon, dyn, ent = self.filter(
                chunk[t], u=None if uc is None else uc[t], qs=q, warm_up=warm_up,
                verbose=True, mask=None if m is None else m[t],
                channel_mask=None if cm is None else cm[t])
            means.append(q.mean)
            logvars.append(q.logvar)
            per_step.append((loss, recon, dyn, ent))
        metrics = core.Metrics(*(torch.stack(f) for f in zip(*per_step)))
        return q, core.EpochResult(state=self.state, q_means=torch.stack(means),
                                   q_logvars=torch.stack(logvars), metrics=metrics)

    # -- batch training ---------------------------------------------------
    def fit(self, y, u=None, *, max_iter: int = 200, beta: Optional[float] = None,
            rtol: Optional[float] = None, verbose: bool = False, callback=None,
            epochs_per_dispatch: int = 1, mask=None, channel_mask=None, mesh=None,
            checkpoint_path: Optional[str] = None, checkpoint_every: int = 0,
            resume_from: Optional[str] = None):
        """Epoch training with warm-up (``models.vjf.fit``), continuing the
        learning-rate schedule of earlier calls; ``beta``/``rtol`` default
        to the config's. ``epochs_per_dispatch > 1``: the blocked mode.
        ``mask``/``channel_mask``: ragged trials and missing channels.
        ``mesh``: a ``dp`` process group or a ``dp`` x ``tp`` mesh
        (``parallel.make_mesh``) to train over several cards
        (``models.vjf.fit``: every rank calls with the whole ``y``; every
        configuration trains, the trials over ``dp`` and, on the autograd
        route, the channels over ``tp``).

        ``y`` may be a list of (T_i, ydim) trials of unequal lengths: they
        are padded and masked (``utils.ragged.pad_trials``; ``u`` and
        ``channel_mask`` must then be per-trial lists too, and ``mask`` not
        given), and the posteriors come back as per-trial lists.

        :return: (posterior means (T, B, xdim), log-variances, final loss)
        """
        from .utils.ragged import pad_trials, split_trials

        lengths = None
        if isinstance(y, (list, tuple)):
            if mask is not None:
                raise ValueError("fit: pass EITHER a list of trials (mask built "
                                 "automatically) OR a padded array + mask, not both")
            for name, v in (("u", u), ("channel_mask", channel_mask)):
                if v is not None and not isinstance(v, (list, tuple)):
                    raise ValueError(f"fit: y is a list of trials, so {name} must be a "
                                     "per-trial list (or None)")
            padded = pad_trials(y, us=u, channel_masks=channel_mask)
            y, u, mask, channel_mask = padded.y, padded.u, padded.mask, padded.channel_mask
            lengths = padded.lengths
        if callback is None and verbose:
            from .utils.metrics import progress_callback

            callback = progress_callback(verbose=True, total=max_iter)
        result = core.fit(self.cfg, self.state, y, u, seed=self._seed(), max_iter=max_iter,
                          beta=beta, rtol=rtol, callback=callback,
                          epochs_per_dispatch=epochs_per_dispatch, mask=mask,
                          channel_mask=channel_mask, mesh=mesh,
                          checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
                          resume_from=resume_from, lr0=self._lr)
        self.state = result.state
        if not result.warm_up:
            self._decoder_frozen = True
        if math.isfinite(result.lr):
            self._lr = float(result.lr)
        self.epochs_run = int(result.epochs_run)
        self.selected_epoch = result.selected_epoch
        self.selected_metric = result.selected_metric
        if lengths is not None:
            return (split_trials(result.mu.cpu(), lengths),
                    split_trials(result.logvar.cpu(), lengths), result.loss)
        return result.mu, result.logvar, result.loss

    def fit_ensemble(self, y, u=None, *, n_models: int, max_iter: int = 200,
                     beta: Optional[float] = None, rtol: Optional[float] = None, callback=None,
                     mask=None, channel_mask=None, mesh=None, seed: Optional[int] = None,
                     epochs_per_dispatch: int = 1, checkpoint_path: Optional[str] = None,
                     checkpoint_every: int = 0, resume_from: Optional[str] = None):
        """Train ``n_models`` independent models (fresh states of this
        model's config) in one launch stream (``parallel.fit_ensemble``):
        seed ensembles, per-subject sweeps. This instance is the template;
        its own state is untouched. ``y``: (T, B, ydim) shared data or (N,
        T, B, ydim) per member; ``epochs_per_dispatch`` K > 1: K epochs a
        dispatch, transitions at block boundaries. ``mesh``: a ``dp``
        process group or a mesh; each rank runs its slice of the members
        (over ``dp``; its ``tp`` peers run the same) and every rank gets all
        N. The init and fit seeds come from ``seed`` or, by
        default, from the model's generator. Returns ``(result,
        members)``: the ``EnsembleFitResult`` and ``n_models`` fitted
        :class:`VJF` instances ready for ``forecast`` and ``filter``."""
        from .parallel import fit_ensemble as _fit_ensemble
        from .parallel import init_ensemble

        base = torch.Generator().manual_seed(self._seed() if seed is None else int(seed))
        k_init, k_fit = core.epoch_seed(base), core.epoch_seed(base)
        states = init_ensemble(k_init, self.cfg, n_models, device=self.device)
        result = _fit_ensemble(
            self.cfg, states, y, u, seed=k_fit, max_iter=max_iter, beta=beta, rtol=rtol,
            callback=callback, mask=mask, channel_mask=channel_mask, mesh=mesh, lr0=self._lr,
            epochs_per_dispatch=epochs_per_dispatch, checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every, resume_from=resume_from)
        members = []
        for i in range(n_models):
            m = object.__new__(VJF)
            m.cfg, m.device = self.cfg, self.device
            m.generator = torch.Generator().manual_seed(core.epoch_seed(base))
            m.state = result.states[i]
            m._step_fn = self._step_fn
            m._lr = float(result.lr[i])
            m.epochs_run = int(result.epochs_run[i])
            m._decoder_frozen = not bool(result.warm_up[i])
            m.selected_epoch = (None if result.selected_epoch is None
                                else int(result.selected_epoch[i]))
            m.selected_metric = (float("nan") if result.selected_metric is None
                                 else float(result.selected_metric[i]))
            members.append(m)
        return result, members

    # -- generation -------------------------------------------------------
    def forecast(self, x0, u=None, n_step: int = 1, *, noise: bool = False):
        """Autoregressive rollout and decode: ``(x, y)``, each (n_step + 1,
        B, ·) including the start."""
        return core.forecast(self.cfg, self.state, self._t(x0), self._seed(), n_step=n_step,
                             u=None if u is None else self._t(u), noise=noise)

    # -- post-hoc smoothing and held-out evaluation -------------------------
    def smooth(self, y, x_ref=None, channel_mask=None, mesh=None, u=None):
        """Parallel-in-time RTS smoothing under the trained model
        (``models/smoothing.py``): the linearized dynamics for a Gaussian
        likelihood, the iterated Laplace smoother for Poisson. Returns
        ``(filtered, smoothed)`` with per-step means and covariances.

        ``y``: one (T, ydim) sequence (:func:`smoothing.smooth`) or a (T, B,
        ydim) batch of trials (:func:`smoothing.smooth_batch`, one batched
        call; ``x_ref`` then (T, B, xdim), results gain a trial axis).
        ``x_ref``: the linearization, one ``(xdim,)`` point (default the
        origin) or a reference trajectory (the transition into step t
        linearized at ``x_ref[t-1]``). ``u``: the controls, required when
        ``udim > 0``, (T, udim), or (T, B, udim) per trial; ``u[t]`` drives
        the transition into step t. ``channel_mask``: optional (T, ydim) or
        (T, B, ydim) 0/1 missing-observation mask (exactly zero gain; the
        stored values may be NaN). ``mesh``: a ``dp`` process group or a
        mesh; a batch's trials are smoothed over its ``dp`` ranks
        (:func:`smoothing.smooth_batch`), one sequence is smoothed whole, as
        in the JAX package."""
        if not hasattr(y, "ndim"):
            y = np.asarray(y)
        if y.ndim == 3:
            return smoothing.smooth_batch(self.cfg, self.state, y, x_ref=x_ref,
                                          channel_mask=channel_mask, mesh=mesh, us=u)
        if mesh is not None:
            from .parallel.sharded import _rank_and_size

            _rank_and_size(mesh)
        return smoothing.smooth(self.cfg, self.state, y, x_ref=x_ref,
                                channel_mask=channel_mask, us=u)

    def evaluate(self, y, heldout, x_ref=None, u=None, n_iter: Optional[int] = None,
                 mesh=None, channel_mask=None):
        """Co-smoothing evaluation (``models/evaluate.py:heldout_eval``):
        infer the latents from the observed channels only (``heldout``
        masked out of the smoother exactly) and score the predictive
        log-likelihood of the held-out channels. Returns a ``HeldoutEval``
        (``loglik`` against the constant-rate null, ``bits_per_spike`` for
        Poisson, ``r2``, the predictions and the smoothed latents).

        ``y``: (T, ydim) or a (T, B, ydim) batch. ``heldout``: int channel
        indices or a boolean (ydim,) mask. ``u`` as in :meth:`smooth`.
        ``channel_mask``: optional observed-entry 0/1 mask, composed with
        ``heldout``. ``mesh``: a ``dp`` process group or a mesh over whose
        ``dp`` ranks a batch's trials are smoothed (with a single sequence
        a ``ValueError``, as in the JAX package)."""
        return EV.heldout_eval(self.cfg, self.state, y, heldout, x_ref=x_ref, us=u,
                               n_iter=n_iter, mesh=mesh, channel_mask=channel_mask)

    def evaluate_kfold(self, y, n_folds: int = 5, seed: int = 0, **kwargs):
        """Population-level co-smoothing: :meth:`evaluate` rotated over
        ``n_folds`` disjoint channel folds, so every channel is scored by a
        smoother that never saw it (``models/evaluate.py:
        kfold_channel_eval``). Returns a ``KFoldEval``. ``kwargs`` as in
        :meth:`evaluate` (``u`` maps to the core's ``us``), and
        ``vmap_folds``/``fold_chunk``."""
        if "u" in kwargs:
            kwargs["us"] = kwargs.pop("u")
        return EV.kfold_channel_eval(self.cfg, self.state, y, n_folds=n_folds, seed=seed,
                                     **kwargs)

    # -- persistence --------------------------------------------------------
    _BLR_BACKENDS = {"PrecisionBLR": "precision", "CovarianceBLR": "covariance",
                     "NSVBLR": "nsv"}

    def save(self, path: str) -> None:
        """Checkpoint the whole model (the state, the learning rate, the
        decoder freeze and the generator) to the one file ``path``."""
        from .utils.checkpoint import FitLoopState, save_checkpoint

        # pin a resolved 'auto' backend, so load() rebuilds the same state
        # type whatever batch_hint or backend built this one
        backend = self._BLR_BACKENDS.get(type(self.state.dynamics.blr).__name__,
                                         self.cfg.rls_backend)
        loop = FitLoopState(epoch=0, lr=float(self._lr), warm_up=not self._decoder_frozen,
                            running_loss=float("nan"), generator=self.generator)
        save_checkpoint(path, self.state, cfg=self.cfg.replace(rls_backend=backend), loop=loop)

    @classmethod
    def load(cls, path: str, device="cuda") -> "VJF":
        """A model saved with :meth:`save`, on ``device``; filtering and
        fitting continue bit-identically."""
        from .utils.checkpoint import load_checkpoint, load_config

        model = cls(load_config(path), device=device)
        model.state, loop = load_checkpoint(path, device=model.device)
        if loop is not None:
            model._lr = loop.lr
            model._decoder_frozen = not loop.warm_up
            model.generator = loop.generator
        return model

    # -- velocity field -----------------------------------------------------
    @_fused.full_f32_matmul()
    def velocity(self, x) -> torch.Tensor:
        """Mean velocity field at query points."""
        x = torch.atleast_2d(self._t(x))
        g = core._transition(self.cfg).transition_gaussian(self.state.dynamics, x, None, 0.0)
        return g.mean - x


def _binary_u8(m: np.ndarray, name: str) -> np.ndarray:
    """A numpy mask as 0/1 uint8 (nonzero -> 1). Fractional values cannot
    travel on this wire, so they are refused rather than rounded."""
    if m.dtype.kind == "f" and not np.isin(m[np.isfinite(m)], (0.0, 1.0)).all():
        raise ValueError(f"filter_stream: numpy {name} must be binary 0/1 (the uint8 wire "
                         "format cannot carry fractional weights); pass a tensor to use "
                         "weights")
    return np.not_equal(m, 0).astype(np.uint8)


class _StreamLoop:
    """The state of one :meth:`VJF.filter_stream` run that its two modes
    share: the posterior carry, the demotion machinery, the stream position
    and its snapshots."""

    def __init__(self, model: VJF, k_block: int, warm_up: bool, checkpoint_path,
                 checkpoint_every: int, resume_from):
        self.model = model
        self.k_block = k_block
        self.warm_up = warm_up
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        self.cfg = model.cfg
        self.chunks_done = self.last_saved = 0
        self.q: Optional[Gaussian] = None
        self.first_checked = False
        self.pending_hot = None      # the previous chunk's (block's) hot fraction
        demoted = False
        if resume_from is not None:
            # restored before the flags, which read the decoder freeze
            snap = core._load_stream_snapshot(model.cfg, resume_from, k_block, warm_up,
                                              model.device)
            self.chunks_done = self.last_saved = snap.chunks_done
            model.state = snap.state
            model.generator = snap.generator
            model._lr = snap.lr
            model._decoder_frozen = snap.decoder_frozen
            if snap.q_mean is not None:
                self.q = Gaussian(snap.q_mean, snap.q_logvar)
            self.first_checked = snap.first_checked
            self.pending_hot = None if snap.pending_hot < 0 else snap.pending_hot
            demoted = snap.demoted
        # hot-tau demotion, fit's policy: the mega kernel drops a sample
        # whose Newton-Schulz bound passes the escalation ceiling, so a
        # pervasively hot regime takes the autograd epoch, whose exact
        # fallback is per step
        self.mega_guard = self.cfg.fused_epoch == "mega"
        if demoted:
            self.demote()

    def flags(self) -> StepFlags:
        return StepFlags(sgd=True, update=True, warm_up=self.warm_up,
                         train_decoder=not self.model._decoder_frozen)

    def demote(self) -> None:
        self.cfg = self.cfg.replace(fused_step="off")
        self.mega_guard = False

    def hot(self, metrics, t_len: int):
        """The hot fraction of an epoch on the mega layout, a tensor on the
        device (no read), or None where no check applies."""
        if (self.mega_guard and not self.warm_up and metrics.tau is not None
                and t_len > self.cfg.ns_prefix):
            return core.epoch_tau_stats(self.cfg, metrics, t_len, torch.float32)[1]
        return None

    def demote_now(self, hot_frac: float, what: str) -> bool:
        if hot_frac <= self.cfg.demote_hot_frac:
            return False
        logger.warning("streaming filter: %.1f%% of %s exceeded the Newton-Schulz escalation "
                       "ceiling (samples dropped); demoting the stream to the autograd epoch "
                       "and re-running the chunk.", 100 * hot_frac, what)
        self.demote()
        return True

    def resolve_pending(self, what: str) -> None:
        if self.pending_hot is None:
            return
        hot_frac, self.pending_hot = float(self.pending_hot), None
        if hot_frac > self.cfg.demote_hot_frac:
            logger.warning("streaming filter: %.1f%% of %s exceeded the Newton-Schulz "
                           "escalation ceiling (samples dropped there and possibly in the work "
                           "now in flight); demoting the rest of the stream to the autograd "
                           "epoch.", 100 * hot_frac, what)
            self.demote()

    def final_check(self, what: str) -> None:
        """The last deferred check: when the stream ends first it would never
        be read, and pervasive dropping there must still be reported."""
        if self.pending_hot is None:
            return
        hot_frac = float(self.pending_hot)
        if hot_frac > self.cfg.demote_hot_frac:
            logger.warning("streaming filter: %.1f%% of %s exceeded the Newton-Schulz "
                           "escalation ceiling (samples dropped; the stream ended before a "
                           "demotion could apply); re-run them with fused_step='off' if "
                           "their updates matter.", 100 * hot_frac, what)

    def advance(self, n: int) -> None:
        """``n`` more chunks consumed; save a snapshot when due."""
        self.chunks_done += n
        if (self.checkpoint_path is None
                or self.chunks_done - self.last_saved < self.checkpoint_every):
            return
        from .utils.checkpoint import save_snapshot

        m = self.model
        save_snapshot(self.checkpoint_path, core._make_stream_snapshot(
            m.cfg, self.chunks_done, m.state, m.generator, m._lr, self.q, self.warm_up,
            m._decoder_frozen, demoted=self.cfg.fused_step == "off" and m.cfg.fused_step != "off",
            first_checked=self.first_checked, pending_hot=self.pending_hot,
            k_block=self.k_block))
        self.last_saved = self.chunks_done
