"""Inference: ``Predictor`` over a saved inference model, and
``GenerativePredictor`` over the port's decode sessions (counterpart of
``paddle_tpu/inference/__init__.py``).

A ``Predictor`` loads what ``fluid.io.save_inference_model`` wrote (by
either package): the pruned program through the load gate, its
parameters onto the card (``Config(place=)``, "cuda" by default), and
serves ``run(feed) -> fetches`` through the port's executor, so the
fused attention ops reach their CUDA kernels. The reference compiles one
XLA executable per feed signature; on the card the port's executor
captures one CUDA graph per signature (at its second run; the first runs
op by op) and replays it after, and each new signature is counted
(``predictor_shape_recompile_total``), which is what a serving ladder
is sized by. A predictor's graphs rewrite their static buffers at every
replay, so one predictor serves one thread at a time; ``clone()`` gives
another thread its own executor and graphs over the same weights.

A model exported with ``save_inference_model(prelower=True)`` carries
step plans and kernel libraries in ``<model_dir>/__prelowered__``; the
predictor registers it as a read-only compile-cache tier (its executor's
``_cache_read_dirs``, and ``kernels/`` as a library tier), so its cold
start loads them instead of building (``fluid/compile_cache.py``).
"""

import contextlib as _contextlib
import os as _os
import time as _time

import numpy as np
import torch

from .. import fluid, resolve_device
from .. import telemetry as _telemetry
from ..fluid import compile_cache as _compile_cache
from ..fluid import monitor as _monitor
from ..kernels import _build
from ..fluid.resilience import Closed, Overloaded
from .serving import Future, GenerativeServer, ServeConfig, Server

__all__ = ["Config", "Predictor", "create_predictor", "PredictorPool",
           "GenerativePredictor", "Server", "GenerativeServer",
           "ServeConfig", "Overloaded", "Closed", "Future"]

_M_RUNS = _monitor.counter(
    "predictor_runs_total", help="Predictor.run calls served")
_M_LATENCY = _monitor.histogram(
    "predictor_run_seconds",
    help="Predictor.run wall time (host->host, numpy materialized)")
_M_RECOMPILES = _monitor.counter(
    "predictor_shape_recompile_total",
    help="Predictor.run calls whose input shapes/dtypes differed from "
         "every signature this predictor served before (the reference "
         "compiles once per signature; pad or bucket inputs to keep "
         "the set small)")
_M_BF16_CASTS = _monitor.counter(
    "predictor_bf16_cast_total",
    help="parameter variables cast float32 -> bfloat16 at predictor "
         "load (Config.enable_bf16)")


class Config:
    """Where the model lives, the device it runs on ("cuda" unless the
    caller passes "cpu"), and which rewrites to apply at load."""

    def __init__(self, model_dir=None, prog_file=None, params_file=None,
                 place="cuda"):
        self.model_dir = model_dir
        self.prog_file = prog_file
        self.params_file = params_file
        self.place = place
        self._use_bf16 = False

    # -- reference-shaped toggles ------------------------------------------
    def enable_bf16(self):
        """Cast float32 parameters to bfloat16 at load. What is computed
        from them alone runs in bf16; a product of an fp32 feed and a
        bf16 weight runs in fp32 (the predictor's executor promotes it,
        as the reference's jnp.matmul does)."""
        self._use_bf16 = True

    def switch_ir_optim(self, flag=True):
        pass  # no IR pass pipeline: the ops run as saved

    def disable_glog_info(self):
        pass

    def enable_memory_optim(self):
        pass  # the executor drops each activation after its last reader

    def set_cpu_math_library_num_threads(self, n):
        pass  # torch's thread pool is process-wide


class Predictor:
    """Loads a saved inference model and serves ``run(feed) ->
    fetches`` (numpy arrays) on ``config.place``."""

    def __init__(self, config, _clone_of=None):
        if isinstance(config, str):  # a bare model directory
            config = Config(model_dir=config)
        self._config = config
        if _clone_of is not None:
            # share the source's weights and parsed program: no disk
            # read, and the scope's contents stay exactly as it serves
            self._exe = fluid.Executor(
                _clone_of._exe.place,
                promote_products=_clone_of._exe.promote_products,
                cuda_graphs=_clone_of._exe.cuda_graphs)
            self._exe._cache_read_dirs = list(_clone_of._exe._cache_read_dirs)
            self._program = _clone_of._program
            self._scope = _clone_of._scope
            self._feed_names = list(_clone_of._feed_names)
            self._fetch_vars = _clone_of._fetch_vars
        else:
            self._exe = fluid.Executor(config.place,
                                       promote_products=config._use_bf16)
            prelowered = _os.path.join(
                config.model_dir or "", _compile_cache.PRELOWERED_DIRNAME)
            if config.model_dir and _os.path.isdir(prelowered):
                self._exe._cache_read_dirs.append(prelowered)
                _build.add_read_dir(_os.path.join(
                    prelowered, _compile_cache.KERNELS_DIRNAME))
            scope = fluid.Scope()
            with fluid.scope_guard(scope):
                program, feeds, fetches = fluid.io.load_inference_model(
                    config.model_dir, self._exe,
                    model_filename=config.prog_file,
                    params_filename=config.params_file)
            if config._use_bf16:
                self._cast_params_bf16(scope)
            self._program = program
            self._scope = scope
            self._feed_names = list(feeds)
            self._fetch_vars = fetches
        self._input_data = {}
        self._outputs = None
        self._seen_sigs = set()

    def _cast_params_bf16(self, scope):
        for name in scope.local_var_names():
            v = scope.find_var(name)
            # int and bool vars (and floats already below fp32) keep
            # their type: only fp32 tensors are cast
            if isinstance(v, torch.Tensor) and v.dtype == torch.float32:
                scope.set_var(name, v.to(torch.bfloat16))
                _M_BF16_CASTS.inc()

    # -- handle-style API (reference GetInputHandle / ZeroCopyTensor) ------
    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return [v.name for v in self._fetch_vars]

    def get_input_handle(self, name):
        return _TensorHandle(self, name)

    def get_output_handle(self, name):
        return _TensorHandle(self, name)

    # -- run ---------------------------------------------------------------
    def run(self, feed=None):
        """feed: {name: ndarray} (or staged through input handles).
        Returns the fetches as numpy arrays. The scope is passed to the
        executor explicitly: ``scope_guard``'s stack is process-wide, so
        two serving threads must not resolve scopes through it."""
        handle_fed = not feed
        feed = dict(feed or self._input_data)
        missing = [n for n in self._feed_names if n not in feed]
        if missing:
            raise ValueError("missing inference feeds: %r" % missing)
        sig = tuple(sorted(
            (n, tuple(np.shape(v)), str(getattr(v, "dtype", "")))
            for n, v in feed.items()))
        if sig not in self._seen_sigs:
            if self._seen_sigs:  # the first signature is the initial one
                _M_RECOMPILES.inc()
            self._seen_sigs.add(sig)
        t0 = _time.perf_counter()
        # a traced request (a serving batch's context is ambient) records
        # the run as a span of its trace
        with (_telemetry.span("predictor.run", attrs={"rows": int(np.shape(
                next(iter(feed.values())))[0]) if feed else 0})
              if _telemetry.enabled() and _telemetry.current() is not None
              else _contextlib.nullcontext()):
            outs = self._exe.run(self._program, feed=feed,
                                 fetch_list=self._fetch_vars,
                                 scope=self._scope)
        _M_LATENCY.observe(_time.perf_counter() - t0)
        _M_RUNS.inc()
        self._outputs = outs
        if handle_fed:
            # staged inputs are consumed: a later run must not reuse
            # the last request's tensors
            self._input_data = {}
        return outs

    def clone(self):
        """A predictor sharing this one's weights and program
        (reference AnalysisPredictor::Clone)."""
        return Predictor(self._config, _clone_of=self)

    @property
    def program(self):
        return self._program


class _TensorHandle:
    """ZeroCopyTensor-shaped accessor."""

    def __init__(self, predictor, name):
        self._p = predictor
        self._name = name

    def copy_from_cpu(self, arr):
        self._p._input_data[self._name] = np.asarray(arr)

    def copy_to_cpu(self):
        if self._p._outputs is None:
            raise RuntimeError(
                "run() has not been called: stage inputs with "
                "copy_from_cpu, call predictor.run(), then read outputs")
        names = self._p.get_output_names()
        return np.asarray(self._p._outputs[names.index(self._name)])

    def reshape(self, shape):
        pass  # shapes are taken from the fed array


def create_predictor(config):
    """Reference ``paddle_infer::CreatePredictor``."""
    return Predictor(config)


class PredictorPool:
    """``size`` predictors sharing one weight scope (reference
    PredictorPool)."""

    def __init__(self, config, size=1):
        if int(size) < 1:
            raise ValueError(
                "PredictorPool size must be >= 1, got %r" % (size,))
        first = Predictor(config)
        self._predictors = [first] + [first.clone()
                                      for _ in range(int(size) - 1)]

    def __len__(self):
        return len(self._predictors)

    def retrieve(self, idx):
        try:
            return self._predictors[idx]
        except IndexError:
            raise IndexError(
                "PredictorPool.retrieve(%r): pool holds %d predictor(s), "
                "valid indices are 0..%d"
                % (idx, len(self._predictors),
                   len(self._predictors) - 1)) from None


class GenerativePredictor:
    """Serves greedy generation from a ``Transformer`` through a decode
    session built once at fixed shapes: the dense ring-cache
    ``DecodeSession`` (``run``; with ``slot_prefill=True`` also its
    continuous-batching ``ContinuousDecodeSession``, ``open_stream``), or
    with ``paged=True`` the paged continuous-batching
    ``PagedDecodeSession`` (``open_stream``). Either stream serves
    ``GenerativeServer``. The model is moved to ``device`` first."""

    def __init__(self, model, batch_size, src_len, prompt_len,
                 cache_capacity, end_id=1, slot_prefill=False, paged=False,
                 page_tokens=None, pool_pages=None, prefix_cache_size=0,
                 device="cuda"):
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
                end_id=end_id, slot_prefill=slot_prefill)

    def open_stream(self):
        """A continuous-batching stream over this predictor's session: the
        ``PagedDecodeSession`` when built with ``paged=True``, else a
        dense ``ContinuousDecodeSession`` (needs ``slot_prefill=True``).
        Both serve the same join/step contract, so ``GenerativeServer``
        drives either."""
        if self._paged:
            return self._session
        if not self._session.slot_prefill:
            raise ValueError(
                "open_stream() needs a continuous-batching engine: build "
                "the predictor with slot_prefill=True (the dense stream) "
                "or paged=True")
        return self._session.open_stream()

    def get_input_names(self):
        return ["src", "prompt", "prompt_lens"]

    def get_output_names(self):
        return ["tokens", "finished"]

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
