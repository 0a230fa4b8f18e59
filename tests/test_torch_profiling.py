"""``utils/profiling``: ``torch.profiler`` behind ``MRGCN_PROFILE_DIR``.

Without the variable (or an argument) ``profile_session`` starts nothing
and writes nothing; with it, on the CPU, it writes a Chrome trace that
holds the spans ``annotate`` and ``PhaseTimer`` name, and the CLI wraps
its task in one.
"""

import json

import torch

from benchmarks.torch_baseline import build_workload
from mrgcn_tpu_torch import run as torch_run
from mrgcn_tpu_torch.tasks.synthetic import save_nc_artifact
from mrgcn_tpu_torch.utils.profiling import (PhaseTimer, annotate,
                                             profile_session)


def _events(directory):
    trace, = directory.glob("trace_*.json")
    return json.loads(trace.read_text())["traceEvents"]


def test_profile_session_without_a_directory_does_nothing(tmp_path,
                                                          monkeypatch):
    monkeypatch.delenv("MRGCN_PROFILE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with profile_session():
        assert not torch.autograd.profiler._is_profiler_enabled
        with annotate("not traced"):
            torch.ones(4).sum()
    assert list(tmp_path.iterdir()) == []


def test_profile_session_writes_a_trace_with_the_annotations(tmp_path,
                                                             monkeypatch):
    out = tmp_path / "profile"
    monkeypatch.setenv("MRGCN_PROFILE_DIR", str(out))
    timer = PhaseTimer()
    with profile_session(device=torch.device("cpu")):
        assert torch.autograd.profiler._is_profiler_enabled
        with annotate("mrgcn_annotated_phase"):
            torch.ones(64, 64).matmul(torch.ones(64, 64))
        with timer.phase("mrgcn_timed_phase"):
            torch.ones(8).sum()
    names = {e.get("name") for e in _events(out)}
    assert {"mrgcn_annotated_phase", "mrgcn_timed_phase"} <= names
    assert any(n and n.startswith("aten::") for n in names)
    assert timer.counts["mrgcn_timed_phase"] == 1
    assert "mrgcn_timed_phase" in timer.summary()


def test_cli_traces_its_task(tmp_path, monkeypatch):
    w = build_workload(n=200, num_props=3, num_edges=800, hidden=8,
                       num_classes=3, num_bases=2, num_labeled=30, seed=0)
    art = tmp_path / "small.npz"
    save_nc_artifact(str(art), w["n"], w["R"], w["src"], w["dst"], w["rel"],
                     w["norm"], w["labels_idx"], w["labels_cls"],
                     w["num_classes"], seed=0, num_eval=20)
    cfg = tmp_path / "p.toml"
    cfg.write_text('name = "PROF"\n[task]\ntype = "node classification"\n'
                   'seed = 0\n[model]\nepoch = 1\nnum_bases = 2\n'
                   '[[model.layers]]\nhidden_nodes = 8\n'
                   '[[model.layers]]\ntype = "mrgcn"\n')
    monkeypatch.setenv("MRGCN_PLATFORM", "cpu")
    monkeypatch.setenv("MRGCN_PROFILE_DIR", str(tmp_path / "trace"))
    res = torch_run.run_cli(["-c", str(cfg), "-i", str(art), "-o",
                             str(tmp_path), "--dry_run", "--test"])
    assert res.epoch == 1
    names = {e.get("name") for e in _events(tmp_path / "trace")}
    assert "aten::index_add_" in names or "aten::mm" in names
