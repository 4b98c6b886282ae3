"""Generative inference: ``GenerativePredictor`` over the port's decode
sessions (counterpart of ``paddle_tpu/inference/__init__.py``'s
``GenerativePredictor``). The plain ``Predictor``, which needs the
Program IR and an executor, is not ported yet."""

import time as _time

import numpy as np

from .. import resolve_device
from ..fluid import monitor as _monitor
from ..fluid.resilience import Closed, Overloaded
from .serving import Future, GenerativeServer

__all__ = ["GenerativePredictor", "GenerativeServer", "Overloaded",
           "Closed", "Future"]

_M_RUNS = _monitor.counter(
    "predictor_runs_total", help="Predictor.run calls served")
_M_LATENCY = _monitor.histogram(
    "predictor_run_seconds",
    help="Predictor.run wall time (host->host, numpy materialized)")

class GenerativePredictor:
    """Serves greedy generation from a ``Transformer`` through a decode
    session built once at fixed shapes: the dense ring-cache
    ``DecodeSession`` (``run``), or with ``paged=True`` the paged
    continuous-batching ``PagedDecodeSession`` (``open_stream``, for
    ``GenerativeServer``). The model is moved to ``device`` first."""

    def __init__(self, model, batch_size, src_len, prompt_len,
                 cache_capacity, end_id=1, paged=False, page_tokens=None,
                 pool_pages=None, prefix_cache_size=0, device="cuda"):
        from ..models.transformer import (build_decode_session,
                                          build_paged_decode_session)

        model.to(resolve_device(device))
        self._paged = bool(paged)
        if self._paged:
            self._session = build_paged_decode_session(
                model, batch_size, src_len, prompt_len, cache_capacity,
                end_id=end_id, page_tokens=page_tokens,
                pool_pages=pool_pages, prefix_cache_size=prefix_cache_size)
        else:
            self._session = build_decode_session(
                model, batch_size, src_len, prompt_len, cache_capacity,
                end_id=end_id)

    def open_stream(self):
        """The paged continuous-batching stream (``paged=True`` only:
        the dense continuous stream is not ported yet)."""
        if not self._paged:
            raise ValueError(
                "open_stream() serves the paged engine: build the "
                "predictor with paged=True")
        return self._session

    def run(self, feed, max_new_tokens):
        """feed: {"src": [B, S] int64, "prompt": [B, P] int64,
        "prompt_lens": [B] (optional; defaults to full P)} at the
        session's shapes. Returns (tokens [B, max_new_tokens] int64,
        finished [B] bool)."""
        if self._paged:
            raise ValueError(
                "paged GenerativePredictor serves through open_stream() "
                "(continuous batching) — batch generate() is the dense "
                "session's path")
        feed = dict(feed)
        missing = [n for n in ("src", "prompt") if n not in feed]
        if missing:
            raise ValueError("missing generative feeds: %r" % missing)
        src, prompt = feed["src"], feed["prompt"]
        lens = feed.get("prompt_lens")
        if lens is None:
            lens = np.full((np.shape(prompt)[0],), np.shape(prompt)[1],
                           np.int64)
        t0 = _time.perf_counter()
        tokens, finished = self._session.generate(src, prompt, lens,
                                                  max_new_tokens)
        _M_LATENCY.observe(_time.perf_counter() - t0)
        _M_RUNS.inc()
        return tokens, finished
