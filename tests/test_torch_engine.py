"""The port's real-execution engine, on the host: ports of
``tests/test_controller_engine.py::TestServingEngine`` (torch MLP segments)
and ``tests/test_cnn_models.py::test_engine_runs_cnn_mix``."""
import threading

import numpy as np
import pytest
import torch

from repro_torch.core.planner import Plan
from repro_torch.models.cnn import PAPER_CNN_SPECS, build_executable
from repro_torch.serving.engine import ExecutableModel, ServingEngine


def _make_mlp_model(name: str, n_segments: int, dim: int, seed: int) -> ExecutableModel:
    rng = np.random.default_rng(seed)
    weights = [
        torch.from_numpy((rng.standard_normal((dim, dim)) / np.sqrt(dim)).astype(np.float32))
        for _ in range(n_segments)
    ]

    def make_seg(w):
        def seg(x):
            return torch.tanh(x @ w.to(x.device))
        return seg

    def make_input(s):
        return torch.from_numpy(
            np.random.default_rng(1000 + s).standard_normal((1, dim)).astype(np.float32)
        )

    return ExecutableModel(
        name=name, segments=tuple(make_seg(w) for w in weights), make_input=make_input
    )


def _engine(models, plan):
    return ServingEngine(models, plan, k_max=4, device="cpu")


class TestServingEngine:
    def test_end_to_end_execution_matches_sequential(self):
        models = [_make_mlp_model("a", 4, 32, 0), _make_mlp_model("b", 3, 32, 1)]
        eng = _engine(models, Plan((2, 1), (1, 1)))
        try:
            inputs = []
            for i, m in enumerate(models):
                for s in range(5):
                    x = m.make_input(s)
                    inputs.append((i, x))
                    eng.submit(i, x)
            done = eng.drain(timeout=30.0)
            assert len(done) == len(inputs)
            assert all(c.ok for c in done)
            # Outputs must equal the plain sequential forward pass.
            by_model = {}
            for c in done:
                by_model.setdefault(c.model_idx, []).append(c)
            for i, m in enumerate(models):
                outs = {c.output.numpy().tobytes() for c in by_model[i]}
                expect = set()
                for s in range(5):
                    x = m.make_input(s)
                    for seg in m.segments:
                        x = seg(x)
                    expect.add(x.numpy().tobytes())
                assert outs == expect
        finally:
            eng.shutdown()

    def test_full_cpu_and_full_tpu_paths(self):
        models = [_make_mlp_model("a", 3, 16, 0), _make_mlp_model("b", 3, 16, 1)]
        eng = _engine(models, Plan((0, 3), (2, 0)))  # model 0 all-CPU, model 1 all-prefix
        try:
            for i in range(2):
                eng.submit(i, models[i].make_input(0))
            done = eng.drain(timeout=30.0)
            assert len(done) == 2 and all(c.ok for c in done)
        finally:
            eng.shutdown()

    def test_plan_switch_live(self):
        models = [_make_mlp_model("a", 4, 16, 0)]
        eng = _engine(models, Plan((4,), (0,)))
        try:
            eng.submit(0, models[0].make_input(0))
            eng.drain(timeout=30.0)
            eng.set_plan(Plan((2,), (2,)))
            eng.submit(0, models[0].make_input(1))
            done = eng.drain(timeout=30.0)
            assert len(done) == 1 and done[0].ok
        finally:
            eng.shutdown()

    def test_rejects_bad_plan(self):
        models = [_make_mlp_model("a", 2, 8, 0)]
        with pytest.raises(ValueError):
            _engine(models, Plan((1, 1), (1, 1)))
        with pytest.raises(ValueError):
            _engine(models, Plan((1,), (5,)))

    def test_segment_exception_surfaces_and_engine_survives(self):
        # A segment that raises must become an errored CompletedRequest --
        # not a dead worker thread holding the in-flight count forever.
        base = _make_mlp_model("a", 2, 16, 0)

        def raise_on_nan(x):
            if bool(torch.isnan(x).any()):
                raise RuntimeError("poisoned input")
            return x

        model = ExecutableModel(
            name="poison",
            segments=(base.segments[0], raise_on_nan, base.segments[1]),
            make_input=base.make_input,
        )
        # (partition, cores): all-prefix exercises the accelerator-worker
        # except path; split exercises the CPU suffix-pool except path.
        for part, cores in ((3, 0), (1, 1)):
            eng = _engine([model], Plan((part,), (cores,)))
            try:
                good = model.make_input(0)
                bad = torch.full((1, 16), float("nan"))
                eng.submit(0, good)
                eng.submit(0, bad)
                eng.submit(0, good)
                done = eng.drain(timeout=30.0)
                assert len(done) == 3
                errs = [c for c in done if not c.ok]
                assert len(errs) == 1
                assert isinstance(errs[0].error, RuntimeError)
                assert errs[0].output is None
                assert all(c.error is None for c in done if c.ok)
                # The engine keeps serving after the failure.
                eng.submit(0, good)
                done2 = eng.drain(timeout=30.0)
                assert len(done2) == 1 and done2[0].ok
            finally:
                eng.shutdown()

    def test_sync_dispatch_failure_releases_inflight_slot(self):
        # Synchronous zero-prefix dispatch failures must both propagate to
        # the submitter and release the in-flight slot so drain() returns.
        models = [_make_mlp_model("a", 2, 8, 0)]
        eng = _engine(models, Plan((0,), (1,)))
        try:
            pool = eng._pools[0]
            eng._pools[0] = None  # simulate a lost suffix pool
            with pytest.raises(RuntimeError):
                eng.submit(0, models[0].make_input(0))
            done = eng.drain(timeout=5.0)
            assert len(done) == 1 and not done[0].ok
            eng._pools[0] = pool
            eng.submit(0, models[0].make_input(1))
            done = eng.drain(timeout=30.0)
            assert len(done) == 1 and done[0].ok
        finally:
            eng.shutdown()

    def test_suffix_workers_run_one_intra_op_thread(self):
        # A plan's k cores for a model are k single-threaded suffix workers.
        seen = []
        lock = threading.Lock()

        def record(x):
            with lock:
                seen.append((threading.current_thread().name, torch.get_num_threads()))
            return x

        model = ExecutableModel("probe", (record, record), make_input=lambda s: torch.zeros(1))
        eng = _engine([model], Plan((1,), (2,)))
        try:
            for s in range(4):
                eng.submit(0, model.make_input(s))
            assert len(eng.drain(timeout=30.0)) == 4
        finally:
            eng.shutdown()
        suffix = [n for name, n in seen if name.startswith("cpu-0")]
        assert len(suffix) == 4 and set(suffix) == {1}

    def test_cuda_engine_raises_without_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingEngine([_make_mlp_model("a", 2, 8, 0)], Plan((1,), (1,)), k_max=4)


def test_engine_runs_cnn_mix():
    models = [
        build_executable(PAPER_CNN_SPECS["mobilenetv2"], seed=0, device="cpu"),
        build_executable(PAPER_CNN_SPECS["squeezenet"], seed=1, device="cpu"),
    ]
    eng = _engine(models, Plan((3, 1), (1, 1)))
    try:
        for i in range(2):
            for s in range(3):
                eng.submit(i, models[i].make_input(s))
        done = eng.drain(timeout=60.0)
        assert len(done) == 6
        for c in done:
            assert c.ok and bool(torch.isfinite(c.output).all())
            last = (PAPER_CNN_SPECS["mobilenetv2"], PAPER_CNN_SPECS["squeezenet"])[c.model_idx]
            assert c.output.shape[-1] == last.stage_channels[-1]
    finally:
        eng.shutdown()
