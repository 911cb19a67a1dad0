"""Captured programs: a function of static device inputs recorded once as a
CUDA graph and replayed, the card's counterpart of a jitted JAX function.

``StepProgram`` serves the Trainer's train and eval steps
(``engine.capture_train_step``, ``capture_eval_step``), the test CLI's
forward with ground truth (``cli/test.py``) and RANSAC
(``ops.ransac.capture_ransac``); ``SplitProgram`` the data-parallel train
step, two graphs around the gradient exchange, which is not captured.
``models.capture_pipeline`` captures the served ``pipeline`` at once, at
load.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Mapping, Optional

import numpy as np
import torch

CAPTURE_WARMUP = 2  # eager passes on a side stream before a capture (PyTorch's recipe)


class StepProgram:
    """A function captured once as a CUDA graph and replayed. The first
    ``CAPTURE_WARMUP`` calls run ``body`` eagerly on a side stream under
    ``torch.cuda.set_sync_debug_mode("error")``, so an op that waits for the
    host raises there with its traceback; the next call captures ``body``
    on its inputs and replays the capture at once, and every later call
    replays it (``prime`` takes the warm-ups and the capture at once, on the
    zeroed inputs). Every call stages its host arrays (``stage(*args)`` ->
    {input: array}) in pinned buffers and copies them into the program's
    static inputs first, so an eager call and a replay run the same code on
    the same tensors.

    A replay returns the program's static outputs: the same tensors every
    call, overwritten by the next replay, valid once the current stream
    reaches them. Calls are serialised by the caller, which consumes (or
    copies) a call's outputs before the next one; programs sharing a
    ``pool`` (``torch.cuda.graph_pool_handle()``) are replayed one at a time.
    ``name`` (the capture function's) heads every error. A failed capture
    raises; nothing falls back to eager. ``generator``, a CUDA generator
    ``body`` draws from, is registered with the graph: each replay draws
    from its state at the call, as an eager call would. After the capture,
    ``launches`` holds each kernel's launches in the program (counted at the
    capture: a replay ticks no wrapper counter), ``path_launches`` the kNN's
    and Sinkhorn's per path, ``capture_s`` the capture's seconds,
    ``memory_bytes`` the device memory it keeps allocated (its outputs) and
    ``reserved_bytes`` what the capture added to the reserved memory (its
    graph pool's growth)."""

    def __init__(self, name: str, body: Callable, stage: Callable, shapes: Mapping,
                 device: torch.device, generator: Optional[torch.Generator] = None, pool=None):
        if torch.device(device).type != "cuda":
            raise ValueError(f"{name}: a CUDA graph needs a CUDA device, got {device}")
        self.name, self.body, self.stage = name, body, stage
        self.device, self.generator, self.pool = device, generator, pool
        # at least one: the optimizer's state must exist before the capture
        self.eager_calls_left = CAPTURE_WARMUP
        with torch.cuda.device(device):
            self.static = {k: torch.zeros(shape, dtype=dtype, device=device)
                           for k, (shape, dtype) in shapes.items()}
            self.host = {k: torch.zeros(shape, dtype=dtype, pin_memory=True)
                         for k, (shape, dtype) in shapes.items()}
            self.side = torch.cuda.Stream(device)
            self.copied = torch.cuda.Event()  # the last call's copies out of the staging buffers
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = None
        self.launches = self.path_launches = None
        self.capture_s = self.memory_bytes = self.reserved_bytes = None

    def __call__(self, *args):
        arrays = self.stage(*args)
        self.copied.synchronize()  # a call not yet run may still read the staging buffers
        for key, buf in self.host.items():
            array = np.asarray(arrays[key])
            value = torch.from_numpy(np.ascontiguousarray(array).reshape(array.shape))
            if tuple(value.shape) != tuple(buf.shape):
                raise ValueError(f"{self.name}: {key} of shape {tuple(value.shape)} "
                                 f"for a program of shape {tuple(buf.shape)}")
            buf.copy_(value)
        with torch.cuda.device(self.device):
            for key, buf in self.static.items():
                buf.copy_(self.host[key], non_blocking=True)
            self.copied.record()
            if self.graph is None and self.eager_calls_left > 0:
                self.eager_calls_left -= 1
                return self._warm_up()
            if self.graph is None:
                self._capture()
            return self._replay()

    def prime(self) -> "StepProgram":
        """The warm-ups and the capture now, on the static inputs as they
        stand (zeros before the first call): every call after this one
        replays. Returns the program."""
        with torch.cuda.device(self.device):
            while self.graph is None and self.eager_calls_left > 0:
                self.eager_calls_left -= 1
                self._warm_up()
            if self.graph is None:
                self._capture()
        return self

    def _warm_up(self):
        return self._eager(self.body, self.static, "")

    def _capture(self) -> None:
        with self._accounting():
            self.graph, self.outputs = self._record("the program", self.body, self.static,
                                                    self.generator)

    def _replay(self):
        self.graph.replay()
        return self.outputs

    def _eager(self, fn: Callable, arg, what: str):
        """``fn(arg)`` on the side stream under the sync check; ``what`` names
        the part in the error."""
        current = torch.cuda.current_stream(self.device)
        self.side.wait_stream(current)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.cuda.stream(self.side):
                out = fn(arg)
        except RuntimeError as e:
            raise RuntimeError(f"{self.name}: the eager warm-up{what} waited for the host: "
                               f"{e}") from e
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        current.wait_stream(self.side)
        return out

    def _record(self, what: str, fn: Callable, arg, generator=None):
        """``fn(arg)`` captured into a new graph on the side stream, over
        ``pool``: (graph, its outputs). Records only: nothing runs."""
        graph = torch.cuda.CUDAGraph()
        if generator is not None:  # each replay draws as the eager call does
            graph.register_generator_state(generator)
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.side):
                outputs = fn(arg)
        except RuntimeError as e:
            raise RuntimeError(f"{self.name}: capturing {what} failed: {e}") from e
        return graph, outputs

    @contextlib.contextmanager
    def _accounting(self):
        """Sets ``launches``, ``path_launches``, ``memory_bytes``,
        ``reserved_bytes`` and ``capture_s`` from the captures inside."""
        from rdmnet_tpu_torch.ops.kernels import all_launch_counts, path_launch_counts

        t0 = time.perf_counter()
        dev = self.device
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        allocated, reserved = torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev)
        counts, paths = all_launch_counts(), path_launch_counts()
        yield
        torch.cuda.synchronize(dev)
        self.launches = {k: v - counts[k] for k, v in all_launch_counts().items()}
        self.path_launches = {k: {p: n - paths[k][p] for p, n in v.items()}
                              for k, v in path_launch_counts().items()}
        self.memory_bytes = torch.cuda.memory_allocated(dev) - allocated
        self.reserved_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.capture_s = time.perf_counter() - t0


class SplitProgram(StepProgram):
    """A step captured as two CUDA graphs around a call that is not
    captured: ``program(*args)`` stages the inputs as ``StepProgram`` does,
    replays ``body(static) -> mid`` (the data-parallel train step's gradient
    half), calls ``between(mid)`` on the current stream (its gradient
    exchange: NCCL enqueues its all-reduces there without waiting; gloo
    passes them through host memory) and replays ``second(mid) -> outputs``
    (its update half), which reads ``mid``, the first graph's static
    outputs, in place: nothing of it is copied.

    The first ``CAPTURE_WARMUP`` calls run body, ``between`` and ``second``
    eagerly, each half on the side stream under the sync check and
    ``between`` outside it. The next call records both halves, one after
    the other, into one graph pool (the second on the first's outputs,
    which stay referenced; recording runs nothing), then runs the step as
    every later call does. ``launches``, ``path_launches``, ``capture_s``,
    ``memory_bytes`` and ``reserved_bytes`` cover both halves;
    ``half_launches`` holds each half's launches. A failed capture raises,
    naming the half; nothing falls back to eager. ``generator`` is
    registered with the first graph."""

    HALVES = ("the gradient half", "the update half")

    def __init__(self, name: str, body: Callable, between: Callable, second: Callable,
                 stage: Callable, shapes: Mapping, device: torch.device,
                 generator: Optional[torch.Generator] = None, pool=None):
        super().__init__(name, body, stage, shapes, device, generator, pool)
        self.between, self.second = between, second
        self.second_graph: Optional[torch.cuda.CUDAGraph] = None
        self.mid = None
        self.half_launches = None

    def _warm_up(self):
        mid = self._eager(self.body, self.static, f" of {self.HALVES[0]}")
        self.between(mid)
        return self._eager(self.second, mid, f" of {self.HALVES[1]}")

    def _capture(self) -> None:
        from rdmnet_tpu_torch.ops.kernels import all_launch_counts

        with self._accounting():
            counts = all_launch_counts()
            graph, mid = self._record(self.HALVES[0], self.body, self.static, self.generator)
            if self.pool is None:  # the second graph allocates from the first's pool
                self.pool = graph.pool()
            half = all_launch_counts()
            second_graph, outputs = self._record(self.HALVES[1], self.second, mid)
            after = all_launch_counts()
        self.half_launches = ({k: half[k] - counts[k] for k in counts},
                              {k: after[k] - half[k] for k in half})
        self.graph, self.second_graph, self.mid, self.outputs = graph, second_graph, mid, outputs

    def _replay(self):
        self.graph.replay()
        self.between(self.mid)
        self.second_graph.replay()
        return self.outputs
