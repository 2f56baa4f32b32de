"""The port's knee tool (``sd_video_gen_tpu_torch/tools/bench_knee.py``)
against the JAX tool (``tools/bench_knee.py``), and ``bench.scenario_train``'s
``precision``.

Tolerances: none. The grid (scenario, batch, precision) and its order are
equal to the JAX tool's, call for call, over a recording fake of each
package's benchmark; each printed line carries the JAX tool's keys; the
real points run at tiny widths on the CPU (``bench.Sizes``), where no kernel
launches.
"""

import importlib
import json
import sys
import types

import pytest
import torch

from sd_video_gen_tpu_torch import bench as B
from sd_video_gen_tpu_torch.tools import bench_knee as K

from test_torch_bench import TINY


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _lines(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def _jax_calls(monkeypatch, capsys, which):
    """The JAX tool's main over a fake ``bench`` that records each call:
    (scenario, batch, precision) and the printed lines."""
    calls = []
    fake = types.ModuleType("bench")

    def scenario_train(batch, precision):
        calls.append(("scenario_train", batch, precision))
        return 10.0, None

    def scenario_denoise(batch):
        calls.append(("scenario_denoise", batch, None))
        return 20.0, None

    fake.scenario_train, fake.scenario_denoise = scenario_train, \
        scenario_denoise
    monkeypatch.setitem(sys.modules, "bench", fake)
    monkeypatch.setattr(sys, "argv", ["bench_knee.py", which])
    importlib.import_module("tools.bench_knee").main()
    return calls, _lines(capsys.readouterr().out)


class FakePortBench(types.SimpleNamespace):
    """The port's benchmark as the knee uses it, recording each call."""

    def __init__(self, fail=None):
        super().__init__(FULL=B.FULL, REPEATS=B.REPEATS, calls=[], fail=fail)

    def _workload(self, fn, batch, precision):
        self.calls.append((fn, batch, precision))
        if self.fail is not None and batch == 24:
            raise self.fail
        return types.SimpleNamespace(batch=batch)

    def scenario_train(self, batch, precision, sizes, device):
        return self._workload("scenario_train", batch, precision)

    def scenario_denoise(self, batch, sizes, device):
        return self._workload("scenario_denoise", batch, None)

    def time_requests(self, name, wl, device, repeats):
        return dict(value=10.0 if name.startswith("train") else 20.0,
                    unit="u", q1=1.0, q3=2.0, best=3.0, spread=0.1, tries=5,
                    batch=wl.batch, precision="bf16", wall_s_median=0.5,
                    launches_in_run={})

    def _free(self, device):
        pass


@pytest.mark.parametrize("which", ["train", "denoise", "all"])
def test_grid_and_order_are_the_jax_tools(monkeypatch, capsys, which):
    want, jax_lines = _jax_calls(monkeypatch, capsys, which)
    fake = FakePortBench()
    monkeypatch.setattr(K, "bench", fake)
    assert K.main([which, "--device", "cpu"]) == 0
    lines = _lines(capsys.readouterr().out)
    assert fake.calls == want
    assert [x["case"] for x in lines] == [x["case"] for x in jax_lines]
    for mine, theirs in zip(lines, jax_lines):
        assert set(theirs) <= set(mine)
        # the JAX keys' values from the same rate and batch
        assert {k: mine[k] for k in theirs} == theirs


def test_only_out_of_memory_is_caught(monkeypatch, capsys):
    """A device OOM prints the JAX tool's error line and the sweep goes on;
    any other failure ends it."""
    fake = FakePortBench(fail=torch.cuda.OutOfMemoryError("out of memory"))
    monkeypatch.setattr(K, "bench", fake)
    assert K.main(["train", "--device", "cpu"]) == 0
    lines = _lines(capsys.readouterr().out)
    assert lines[3] == {"case": "train_bf16_full_b24",
                        "error": "out of memory"}
    assert len(lines) == len(K.TRAIN_GRID)
    monkeypatch.setattr(K, "bench", FakePortBench(fail=RuntimeError("bad")))
    with pytest.raises(RuntimeError, match="bad"):
        K.main(["train", "--device", "cpu"])


@pytest.mark.parametrize("case", ["train_bf16_full_b48", "train_f32_b6",
                                  "denoise_b16"])
def test_real_point_on_the_cpu(capsys, case):
    """One point of each sweep through the port's benchmark at tiny widths:
    its line, a rate, and no launch on the CPU."""
    (_, scenario, kwargs), = [p for p in K.points() if p[0] == case]
    line = K.run_point(case, scenario, kwargs, TINY, "cpu", repeats=1)
    assert _lines(capsys.readouterr().out)[-1] == line
    key = "steps_per_s" if scenario == "scenario_train" else \
        "frames_per_s_chip"
    assert line[key] > 0 and line["value"] > 0 and line["tries"] == 1
    if scenario == "scenario_train":
        assert line["clips_per_s"] == round(line["value"] * line["batch"], 1)
        assert line["precision"] == ("f32" if "f32" in case else "bf16")
    assert all(not v for v in line["launches_in_run"].values())


@pytest.mark.parametrize("precision", ["f32", "bf16", "bf16_full"])
def test_scenario_train_takes_the_trainers_precision(precision):
    wl = B.scenario_train(2, precision, sizes=TINY, device="cpu")
    assert wl.keep["trainer"].precision == precision
    assert wl.keep["path"]["name"] == "train_flagship"
    assert wl.unit == "steps/sec/chip" and wl.batch == 2


def test_train_flagship_keeps_bf16_full():
    """The scenario ``train_flagship`` (SCENARIOS' entry, its defaults) is
    batch 6 in ``bf16_full``, as the JAX bench's."""
    fn = dict(B.SCENARIOS)["train_flagship"]
    wl = fn(sizes=B.Sizes(**{**TINY.__dict__, "max_batch": None}),
            device="cpu")
    assert wl.keep["trainer"].precision == "bf16_full"
    assert wl.batch == 6 and wl.precision == "bf16"
