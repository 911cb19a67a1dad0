"""Captured programs: a function of static device inputs recorded once as a
CUDA graph and replayed, the card's counterpart of a jitted JAX function.

``StepProgram`` serves the Trainer's train and eval steps
(``engine.capture_train_step``, ``capture_eval_step``), the test CLI's
forward with ground truth (``cli/test.py``) and RANSAC
(``ops.ransac.capture_ransac``). ``models.capture_pipeline`` captures the
served ``pipeline`` at once, at load.
"""

from __future__ import annotations

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
                return self._eager()
            if self.graph is None:
                self._capture()
            self.graph.replay()
        return self.outputs

    def prime(self) -> "StepProgram":
        """The warm-ups and the capture now, on the static inputs as they
        stand (zeros before the first call): every call after this one
        replays. Returns the program."""
        with torch.cuda.device(self.device):
            while self.graph is None and self.eager_calls_left > 0:
                self.eager_calls_left -= 1
                self._eager()
            if self.graph is None:
                self._capture()
        return self

    def _eager(self):
        current = torch.cuda.current_stream(self.device)
        self.side.wait_stream(current)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.cuda.stream(self.side):
                out = self.body(self.static)
        except RuntimeError as e:
            raise RuntimeError(f"{self.name}: the eager warm-up waited for the host: {e}") from e
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        current.wait_stream(self.side)
        return out

    def _capture(self) -> None:
        from rdmnet_tpu_torch.ops.kernels import all_launch_counts, path_launch_counts

        t0 = time.perf_counter()
        dev = self.device
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        allocated, reserved = torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:  # each replay draws as the eager call does
            graph.register_generator_state(self.generator)
        counts, paths = all_launch_counts(), path_launch_counts()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.side):
                outputs = self.body(self.static)
        except RuntimeError as e:
            raise RuntimeError(f"{self.name}: capturing the program failed: {e}") from e
        torch.cuda.synchronize(dev)
        self.launches = {k: v - counts[k] for k, v in all_launch_counts().items()}
        self.path_launches = {k: {p: n - paths[k][p] for p, n in v.items()}
                              for k, v in path_launch_counts().items()}
        self.memory_bytes = torch.cuda.memory_allocated(dev) - allocated
        self.reserved_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.capture_s = time.perf_counter() - t0
        self.graph, self.outputs = graph, outputs
