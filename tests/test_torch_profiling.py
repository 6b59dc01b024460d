"""The port's timing and tracing module (tango_tpu_torch/utils/profiling.py)
against JAX's (tango_tpu/utils/profiling.py): the same names, signatures and
return keys (tests/test_utils.py:36-43), and `trace`'s chrome trace of a CPU
function."""

import inspect
import json

import jax
import jax.numpy as jnp
import pytest
import torch

from tango_tpu.utils import profiling as jp
from tango_tpu_torch.utils import profiling as tp

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["sync", "device_timer", "trace", "realtime_factor"])
def test_signatures_match_jax(name):
    """JAX's parameters, in its order, with its defaults but `trace`'s
    logdir (under the temporary directory here, not a fixed /tmp path)."""
    jsig, tsig = inspect.signature(getattr(jp, name)), inspect.signature(getattr(tp, name))
    assert list(jsig.parameters) == list(tsig.parameters)
    if name != "trace":
        assert [p.default for p in jsig.parameters.values()] == \
            [p.default for p in tsig.parameters.values()]
    assert not hasattr(tp, "setup_compilation_cache")


def test_device_timer_keys_and_realtime_factor_match_jax():
    """tests/test_utils.py:36-43 on the port: the same keys and iteration
    count as JAX's timer on the same work; realtime_factor's values."""
    x = torch.ones(64, 64)
    stats = tp.device_timer(lambda a: a * 2 + 1, x, iters=3)
    ref = jp.device_timer(jax.jit(lambda a: a * 2 + 1), jnp.ones((64, 64)), iters=3)
    assert set(stats) == set(ref) == {"p50_s", "mean_s", "min_s", "iters"}
    assert stats["iters"] == ref["iters"] == 3
    assert 0 < stats["min_s"] <= stats["p50_s"] and stats["min_s"] <= stats["mean_s"]
    for args in ((10.24, 2.0), (10.24, 2.0, 4), (30.0, 7.5, 2)):
        assert tp.realtime_factor(*args) == jp.realtime_factor(*args)
    assert tp.realtime_factor(10.24, 2.0) == 5.12


def test_sync_takes_any_tree(monkeypatch):
    """sync of a tensor, a nested tree whose first tensor leaf is on the CPU,
    and a tree without tensors: nothing to wait for, no card synchronized."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(a))
    tp.sync(torch.ones(3))
    tp.sync({"a": [1, (torch.zeros(2), torch.ones(1))], "b": None})
    tp.sync([])
    tp.sync({"n": 3})
    assert tp._first_tensor({"a": [1, (torch.zeros(2), None)]}).shape == (2,)
    assert tp._first_tensor([1, "x"]) is None
    assert not calls


def test_trace_writes_a_chrome_trace(tmp_path):
    """trace(logdir) yields logdir and writes one chrome trace there whose
    events include the traced CPU function's ops."""
    a, b = torch.randn(32, 32), torch.randn(32, 32)
    with tp.trace(str(tmp_path / "t")) as logdir:
        assert logdir == str(tmp_path / "t")
        c = torch.mm(a, b).relu()
    files = list((tmp_path / "t").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names and "aten::relu" in names
    assert torch.equal(c, torch.mm(a, b).relu())
