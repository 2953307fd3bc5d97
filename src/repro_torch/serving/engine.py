"""Real-execution multi-tenant engine (Section IV plumbing) in PyTorch.

Port of the JAX package's ``serving/engine.py``.  A single global
accelerator-worker thread drains an FCFS queue of prefix executions on the
engine's device (the GPU), then copies the activation at the split to the
host once and hands it to the model's CPU thread pool, which runs the
suffix.  Latency *validation* is done against the simulator, which models
the paper's testbed timing; this module proves the runtime plumbing
(queues, pools, plan switches, error containment) with real tensors.

A segment maps an activation to the next on the activation's own device,
so one model serves prefixes on the GPU and suffixes on the host from
weights it keeps on both (``models/cnn.py``), and a plan switch moves the
split without moving weights.

Host threads: each pool worker runs its suffix with one intra-op thread
(``torch.set_num_threads(1)`` in the worker's initializer), so the k
workers a plan gives a model hold at most k cores, the k servers of the
analytic model's CPU queue.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Sequence

import torch

from repro_torch.core.planner import Plan
from repro_torch.device import resolve_device

# A partitioned executable model: segment i maps activations -> activations.
SegmentFn = Callable[[Any], Any]


@dataclasses.dataclass
class ExecutableModel:
    """A chain of segment functions + an input synthesizer."""

    name: str
    segments: tuple[SegmentFn, ...]
    make_input: Callable[[int], Any]   # seed -> model input (on the host)

    @property
    def num_partition_points(self) -> int:
        return len(self.segments)


@dataclasses.dataclass
class CompletedRequest:
    model_idx: int
    submit_time: float
    done_time: float
    output: Any
    # The exception that aborted this request's execution, or None on
    # success (``output`` is None for errored records).  Errors surface as
    # completed records instead of vanishing inside worker threads, so
    # ``drain()`` always terminates and the caller sees every failure.
    error: BaseException | None = None

    @property
    def latency(self) -> float:
        return self.done_time - self.submit_time

    @property
    def ok(self) -> bool:
        return self.error is None


class _TpuWorker(threading.Thread):
    """Single global FCFS worker executing accelerator prefixes."""

    def __init__(self, engine: "ServingEngine"):
        super().__init__(daemon=True, name="tpu-worker")
        self.engine = engine
        self.inbox: "queue.Queue" = queue.Queue()

    def run(self) -> None:
        while True:
            item = self.inbox.get()
            if item is None:
                return
            self.engine._run_prefix(*item)


def _one_intra_op_thread() -> None:
    torch.set_num_threads(1)


class ServingEngine:
    """Multi-tenant collaborative-inference engine over executable models.

    Prefixes run on ``device`` (default the GPU; raises when there is none
    and ``"cpu"`` was not asked for); suffixes run on the host.
    """

    def __init__(
        self,
        models: Sequence[ExecutableModel],
        plan: Plan,
        k_max: int,
        device: "str | torch.device" = "cuda",
    ):
        self.models = list(models)
        self.k_max = k_max
        self.device = resolve_device(device)
        self._plan_lock = threading.Lock()
        self._tpu = _TpuWorker(self)
        self._pools: list[ThreadPoolExecutor | None] = [None] * len(models)
        self._completed: "queue.Queue[CompletedRequest]" = queue.Queue()
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._drained = threading.Event()
        self._drained.set()
        self.set_plan(plan)
        self._tpu.start()

    # -- configuration -------------------------------------------------------
    def set_plan(self, plan: Plan) -> None:
        if len(plan.partition) != len(self.models):
            raise ValueError("plan size mismatch")
        if sum(plan.cores) > self.k_max:
            raise ValueError("plan exceeds K_max")
        with self._plan_lock:
            self.plan = plan
            for i, k in enumerate(plan.cores):
                old = self._pools[i]
                if old is not None:
                    old.shutdown(wait=False)
                self._pools[i] = (
                    ThreadPoolExecutor(
                        max_workers=k,
                        thread_name_prefix=f"cpu-{i}",
                        initializer=_one_intra_op_thread,
                    )
                    if k > 0
                    else None
                )

    # -- request path ----------------------------------------------------------
    def submit(self, model_idx: int, x: Any) -> None:
        with self._inflight_lock:
            self._inflight += 1
            self._drained.clear()
        submit_t = time.perf_counter()
        with self._plan_lock:
            p = self.plan.partition[model_idx]
        if p > 0:
            self._tpu.inbox.put((model_idx, x, p, submit_t))
        else:
            try:
                self._dispatch_suffix(model_idx, x, 0, submit_t)
            except BaseException as exc:
                # The synchronous dispatch path (zero-core misconfiguration,
                # pool rejection) must not leak the in-flight slot it just
                # claimed: record the failure so drain() terminates, then
                # surface it to the submitter.
                self._finish(model_idx, None, submit_t, error=exc)
                raise

    def _run_prefix(self, model_idx: int, x: Any, p: int, submit_t: float) -> None:
        # Any failure here (a segment raising, a missing suffix pool) would
        # otherwise die inside the worker thread with the in-flight count
        # still held, hanging every future drain().
        try:
            m = self.models[model_idx]
            x = x.to(self.device)
            for seg in m.segments[:p]:
                x = seg(x)
            # The one device-to-host copy: a blocking .cpu() waits for the
            # stream to finish the prefix (the reference's block_until_ready),
            # whether the activation goes on to a suffix or is the output.
            x = x.cpu()
            if p < m.num_partition_points:
                self._dispatch_suffix(model_idx, x, p, submit_t)
            else:
                self._finish(model_idx, x, submit_t)
        except BaseException as exc:
            self._finish(model_idx, None, submit_t, error=exc)

    def _dispatch_suffix(self, model_idx: int, x: Any, p: int, submit_t: float) -> None:
        pool = self._pools[model_idx]
        if pool is None:
            raise RuntimeError(
                f"model {model_idx} has a CPU suffix but zero cores allocated"
            )

        def work() -> None:
            # Same containment as _run_prefix: a suffix failure becomes an
            # errored completion record, never a silently swallowed pool
            # exception plus a leaked in-flight slot.  Host ops are
            # synchronous, so the output is ready when the loop ends.
            try:
                y = x.cpu()
                m = self.models[model_idx]
                for seg in m.segments[p:]:
                    y = seg(y)
            except BaseException as exc:
                self._finish(model_idx, None, submit_t, error=exc)
            else:
                self._finish(model_idx, y, submit_t)

        pool.submit(work)

    def _finish(
        self,
        model_idx: int,
        out: Any,
        submit_t: float,
        error: BaseException | None = None,
    ) -> None:
        self._completed.put(
            CompletedRequest(
                model_idx=model_idx,
                submit_time=submit_t,
                done_time=time.perf_counter(),
                output=out,
                error=error,
            )
        )
        with self._inflight_lock:
            self._inflight -= 1
            if self._inflight == 0:
                self._drained.set()

    # -- collection ------------------------------------------------------------
    def drain(self, timeout: float = 60.0) -> list[CompletedRequest]:
        if not self._drained.wait(timeout):
            raise TimeoutError("engine did not drain in time")
        out = []
        while True:
            try:
                out.append(self._completed.get_nowait())
            except queue.Empty:
                return out

    def shutdown(self) -> None:
        self._tpu.inbox.put(None)
        for pool in self._pools:
            if pool is not None:
                pool.shutdown(wait=True)
